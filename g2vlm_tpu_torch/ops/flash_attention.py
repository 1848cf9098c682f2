"""The attention kernels of the main paths, their wrappers, plain versions,
autograd Functions and launch counters.

Forwards. K1 `flash_batched_attention` (csrc/attention_batched.cu) replaces
g2vlm_tpu/ops/flash_attention.py `_batched_flash_kernel` (called through
`_batched_fwd`): bidirectional attention inside each batch element, for the
DINOv2 encoder and the Pi3 decoders; its products run on wgmma from a ring of
cp.async / mbarrier stages that two or three warpgroups read, on a persistent
grid (`batched_fwd_grid`). K2 `flash_segment_attention`
(csrc/attention_segment.cu) replaces `_flash_kernel` (called through
`_fwd_pallas`): packed segment-masked GQA attention, for the MoT decoder and
the Qwen2-VL ViT; its products run on wgmma from a cp.async / mbarrier ring
whose K/V stages, tile codes and masks the query heads of a GQA group share
(`segment_fwd_grid`). At head dim 128 (the decoder's) K2 and K3 run a
warp-specialised schedule instead: a producer warpgroup fills the ring by TMA
and builds the masks, and two consumer warpgroups take turns on the tensor
cores (`segment_warpgroups`; counted apart in
launch_counts["flash_segment_attention_ws"]).
K6 and K3 are the same kernels with a per-row
log-sum-exp output, replacing `_batched_flash_kernel_lse` and
`_flash_kernel_lse`: the training forwards.

K4 `flash_segment_attention(..., pipelined=True)` (csrc/attention_segment.cu,
the same template) replaces `_flash_kernel_pipe` (the pipe branch of
`_fwd_pallas`): K2's and K3's function in a two-stage schedule, QK^T of one
tile issued with P.V of the tile before it, the softmax under both. K8
`flash_segment_attention_int8` (csrc/attention_segment.cu, the same template
again, serial) replaces `_flash_kernel_int8` (through `_flash_int8`): K2's
function with QK^T as an s8 wgmma (int8 x int8 -> int32) on per-token scales,
the quantized serving mode's prefill attention, on K2's grid, ring and masks;
its quantiser `quantize_qk` is plain tensor code here, as the JAX package
keeps it outside its kernel. Every segment kernel (K2, K3, K4, K8 and the
backward K5) also takes the Qwen2-VL ViT's head dim 80, zero-padded to 96 in
shared memory: K2 / K4 / K8 serve the chat path's ViT, K3 and K5 train it.

The MLA forward `flash_mla_attention` (csrc/attention_segment.cu
`mla_fwd_kernel`, the port's own: the JAX package has no such layer) is K2's
function, plan and warp-specialised block where the queries and keys are
wider than the values: the prefill form of the "mla_moe" decoder's latent
attention (Kimi-VL-A3B), 16:16 heads with QK head dim 192 (128 nope + 64 rope
columns) and V head dim 128 (`MLA_HEAD_DIMS`), inference only. Its kernel has
a name of its own, so a trace tells its launches from K2's.

Backwards (csrc/attention_bwd.cu). K7 replaces `_batched_bwd_dq_kernel` and
`_batched_bwd_dkv_kernel` (through `_batched_vjp_bwd`), K5 replaces
`_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (through `_flash_bwd`):
from q, k, v, dO, lse and delta = rowsum(dO * O) they recompute P per tile and
give dQ (one kernel) and dK, dV (another, the GQA group summed inside it).
Every product there is a Hopper `wgmma.mma_async`, fed through a ring of
cp.async stages on mbarriers (csrc/hopper_common.cuh); `bwd_blocks` and
`dkv_head_split` reckon their grids on the host.

All are CUDA C++ for sm_90a, built with nvcc into plain-C shared libraries at
first use (one per source, in parallel) and called through ctypes; the MoT
decode step's kernels (csrc/decode_fused.cu, wrapped by ops/decode_fused.py)
build with them.

What bounds them on the H100: tensor-core FLOPs (K8: int8 operations for
QK^T, bf16 for P.V). K2 at the 32-view prefill
(25,088 rows, 12 heads of 128) is 3.9 TFLOP per launch on ~0.2 GB of q/k/v/o;
at the training pack of 12,800 rows K3 is 1.0, K5's dq kernel 1.5 and its dkv
kernel 2.0 TFLOP; K1 at a DINOv2-L view batch (32, 782, 16, 64) is 80 GFLOP.
All keep the logits, P and dS out of device memory (fp32 softmax statistics
in registers over 64-row tiles fed to wgmma tensor-core products), and the
segment kernels skip the per-element mask on tiles their codes prove fully
visible, and whole tiles the codes prove invisible (the .cu headers have the
details).

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor takes the plain version beside the kernel. Nothing falls back. An
input that requires grad goes through the autograd Function of its form (lse
forward, kernel backward); otherwise the plain forward runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .attention import dense_attention, segment_attention_chunked
from .masks import TokenInfo, make_segment_mask

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
# one shared library per source, all built at once by parallel nvcc processes
_SOURCES = (_CSRC / "attention_segment.cu", _CSRC / "attention_bwd.cu", _CSRC / "attention_batched.cu",
            _CSRC / "decode_fused.cu")
_HEADERS = (_CSRC / "attention_common.cuh", _CSRC / "hopper_common.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (64, 96, 128)  # the batched kernels (K1, K6, K7)
# the segment kernels (K2-K5, K8) also take the Qwen2-VL ViT's head dim
SEGMENT_HEAD_DIMS = (64, 80, 96, 128)
TILE = 64  # the tile of the codes: a warpgroup's query rows and a K/V stage's keys in every kernel
SEGMENT_WARPGROUPS = 3  # consumer warpgroups of a lockstep block: K4, K8, and K2 / K3 below head dim 128 (kWgs)
WS_WARPGROUPS = 2  # consumer warpgroups of K2 / K3's warp-specialised block at head dim 128 (kWsWgs)
WS_HEAD_DIM = 128  # the head dim whose K2 / K3 run the warp-specialised schedule
MLA_HEAD_DIMS = (192, 128)  # (QK, V) head dims of the MLA forward, on K2's warp-specialised block
BWD_KEYS_PER_BLOCK = 2 * TILE  # the dkv kernel's block: two warpgroups of 64 keys
SPLIT_SLACK = 0.1  # dkv_head_split: waves a cut of the GQA group must save, as a share
BLOCK_SKIP, BLOCK_PARTIAL, BLOCK_FULL = 0, 1, 2
LSE_EMPTY = -1e30  # lse of a row that sees no key (kLseEmpty; g2vlm_tpu's NEG_INF)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

# Launches of each kernel; a wrapper adds one exactly where it launches.
launch_counts: Dict[str, int] = {
    "flash_batched_attention": 0,  # K1
    "flash_segment_attention": 0,  # K2
    "flash_segment_attention_lse": 0,  # K3
    "flash_segment_attention_pipe": 0,  # K4 (with or without lse)
    "flash_segment_attention_bwd_dq": 0,  # K5
    "flash_segment_attention_bwd_dkv": 0,
    "flash_batched_attention_lse": 0,  # K6
    "flash_batched_attention_bwd_dq": 0,  # K7
    "flash_batched_attention_bwd_dkv": 0,
    "flash_segment_attention_int8": 0,  # K8
    "flash_segment_attention_ws": 0,  # of the K2 and K3 launches, those of the warp-specialised schedule
    "flash_mla_attention": 0,  # the MLA forward (QK head dim 192, V 128)
}

_libs: Optional[Tuple[ctypes.CDLL, ...]] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def find_nvcc() -> str:
    """nvcc from PATH, $CUDA_HOME/bin or /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build_library() -> Tuple[Tuple[Path, ...], str]:
    """Compile each csrc/*.cu into its own shared library in BUILD_DIR (keyed
    by a hash of all sources, headers and flags), the missing ones in parallel.
    Returns (paths in _SOURCES order, compiler output)."""
    digest = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    outs = tuple(BUILD_DIR / f"libg2vlm_{src.stem}_{key}.so" for src in _SOURCES)
    jobs = []
    for src, out in zip(_SOURCES, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = "", ""
    for out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed += f"nvcc failed ({proc.returncode}) for {out.name}:\n{stdout}\n{stderr}\n"
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
            log += stdout + stderr
    if failed:
        raise RuntimeError(failed)
    return outs, log


def load_library() -> Tuple[ctypes.CDLL, ...]:
    """(segment forward, backward, batched forward, decode step) libraries,
    built at first use; ops/decode_fused.py wraps the last."""
    global _libs
    if _libs is None:
        paths, _ = build_library()
        seg, bwd, batched, decode = (ctypes.CDLL(str(path)) for path in paths)
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        batched.g2_batched_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i] + [ll] * 9 + [f, p, i]
        batched.g2_batched_attention.restype = i
        batched.g2_batched_attention_blocks_per_sm.argtypes = [i, i, i]
        batched.g2_batched_attention_blocks_per_sm.restype = i
        batched.g2_batched_attention_rows_per_block.argtypes = [i]
        batched.g2_batched_attention_rows_per_block.restype = i
        for fn in (seg.g2_segment_attention, seg.g2_segment_attention_pipe):
            fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i] + [ll] * 6 + [f, p, i]
            fn.restype = i
        seg.g2_mla_attention.argtypes = [i] + [p] * 7 + [i] * 6 + [ll] * 6 + [f, p, i]
        seg.g2_mla_attention.restype = i
        seg.g2_segment_attention_warpgroups.argtypes = [i, i, i]
        seg.g2_segment_attention_warpgroups.restype = i
        for d in SEGMENT_HEAD_DIMS:
            for pipelined, int8 in ((False, False), (True, False), (False, True)):
                if seg.g2_segment_attention_warpgroups(d, pipelined, int8) != segment_warpgroups(d, pipelined, int8):
                    raise RuntimeError(f"attention_segment.cu: its blocks' warpgroups at head dim {d} (pipelined "
                                       f"{pipelined}, int8 {int8}) differ from segment_warpgroups")
        bwd.g2_attention_bwd_dq.argtypes = [i, i] + [p] * 10 + [i] * 6 + [ll] * 9 + [f, p]
        bwd.g2_attention_bwd_dq.restype = i
        bwd.g2_attention_bwd_dkv.argtypes = [i, i] + [p] * 9 + [i] + [p] * 3 + [i] * 7 + [ll] * 9 + [f, p]
        bwd.g2_attention_bwd_dkv.restype = i
        seg.g2_segment_attention_int8.argtypes = [i] + [p] * 9 + [i] * 6 + [ll] * 6 + [p, i]
        seg.g2_segment_attention_int8.restype = i
        decode.g2_decode_attention.argtypes = [i, i] + [p] * 5 + [i, f] + [p] * 8 + [i] * 5 + [ll] * 5 + [f, p]
        decode.g2_decode_attention.restype = i
        decode.g2_add_rms_norm.argtypes = [i] + [p] * 3 + [i] + [p] * 2 + [i, i, f] + [ll] * 4 + [p]
        decode.g2_add_rms_norm.restype = i
        decode.g2_decode_constants.argtypes = [i]
        decode.g2_decode_constants.restype = i
        _libs = (seg, bwd, batched, decode)
    return _libs


def _check_cuda_inputs(name: str, *tensors: torch.Tensor, head_dims=HEAD_DIMS) -> None:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes bf16 or fp16, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be 16-byte aligned (strides {t.stride()})")
    if tensors[0].shape[-1] not in head_dims:
        raise ValueError(f"{name}: head dim {tensors[0].shape[-1]} not in {head_dims}")


def bwd_blocks(n_q: int, n_kv_store: int, h: int, kvh: int, batch: int, n_split: int) -> Tuple[int, int]:
    """(dq blocks, dkv blocks) of the backward kernels' grids, as `launch_bwd`
    in csrc/attention_bwd.cu makes them: a dq block takes 64 query rows of two
    query heads of a GQA group (an odd group: of one head, and two query
    tiles), a dkv block BWD_KEYS_PER_BLOCK keys of one KV head and one of the
    group's `n_split` slices of query heads."""
    group = h // kvh
    heads = 2 if group % 2 == 0 else 1
    q_tiles = -(-n_q // TILE)
    dq = -(-q_tiles // (2 // heads)) * kvh * (group // heads) * batch
    dkv = -(-n_kv_store // BWD_KEYS_PER_BLOCK) * kvh * n_split * batch
    return dq, dkv


def dkv_head_split(n_q: int, n_kv_store: int, h: int, kvh: int, batch: int, n_sm: int) -> int:
    """Slices of each GQA group for the dkv kernel. A block holds its dK and
    dV in registers (one block per SM), so 200 blocks on 132 SMs run in two
    waves with the second two-thirds idle; cut into s slices, the group takes
    ceil(blocks * s / n_sm) waves of 1/s the work. The smallest s (a divisor
    of the group) within SPLIT_SLACK of the fewest such waves, counted in
    units of a whole block: each slice writes fp32 partial sums that a second
    kernel adds in order, so a cut has to buy more than a few percent."""
    group = h // kvh
    splits = [s for s in range(1, group + 1) if group % s == 0]
    waves = [-(-bwd_blocks(n_q, n_kv_store, h, kvh, batch, s)[1] // n_sm) / s for s in splits]
    return next(s for s, w in zip(splits, waves) if w <= min(waves) * (1 + SPLIT_SLACK))


def _dkv_scratch(q: torch.Tensor, n_kv_store: int, h: int, kvh: int, batch: int):
    """(n_split, fp32 partial-sum scratch or None) for a dkv launch on q's card."""
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = dkv_head_split(q.shape[-3], n_kv_store, h, kvh, batch, n_sm)
    if n_split == 1:
        return 1, None
    part = torch.empty((n_split, 2, batch, n_kv_store, kvh, q.shape[-1]), dtype=torch.float32, device=q.device)
    return n_split, part


def batched_fwd_grid(b: int, s: int, h: int, rows_per_block: int, n_sm: int, per_sm: int) -> Tuple[int, int]:
    """(items, blocks) of a K1 / K6 launch (csrc/attention_batched.cu). An item
    is one (b, h) and the query rows [i rows_per_block, (i + 1) rows_per_block)
    of it, 64 for each consumer warpgroup; items are numbered (b, h, query
    block) in that order. The grid is persistent: as many blocks as fit on the
    card at once (`per_sm` on each of `n_sm` SMs), no more than there are
    items, and block i walks items i, i + blocks, ...: neighbouring blocks hold
    neighbouring query blocks of one (b, h), so they read the same K/V from L2."""
    items = b * h * -(-s // rows_per_block)
    return items, min(items, n_sm * per_sm)


@functools.lru_cache(maxsize=None)
def _batched_launch_shape(dtype: torch.dtype, d: int, with_lse: bool) -> Tuple[int, int]:
    """(query rows of a block, blocks that fit on one SM at once) of the K1 / K6 kernel, as the
    library reports them."""
    lib = load_library()[2]
    rows = lib.g2_batched_attention_rows_per_block(d)
    per_sm = lib.g2_batched_attention_blocks_per_sm(_DTYPES[dtype], d, int(with_lse))
    if rows < 1 or per_sm < 1:
        raise RuntimeError(f"flash_batched_attention: no block of head dim {d} fits on an SM ({rows}, {per_sm})")
    return rows, per_sm


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# K1 / K6 / K7: batched bidirectional attention, its lse forward and backward
# ---------------------------------------------------------------------------

def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 when given fp64."""
    return torch.promote_types(t.dtype, torch.float32)


def flash_batched_attention_reference(q, k, v, valid_kv: Optional[int] = None, scale=None):
    """Plain version of K1: dense attention with keys >= valid_kv masked."""
    m = k.shape[1]
    if valid_kv is not None and valid_kv < m:
        mask = torch.arange(m, device=q.device) < valid_kv
        return dense_attention(q, k, v, mask=mask[None, None, None, :], scale=scale)
    return dense_attention(q, k, v, scale=scale)


def _batched_probs(q, k, lse, valid_kv, scale):
    """P = exp(scale q k^T - lse) (B, H, S, M), keys >= valid_kv zeroed."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(logits - lse[..., None])
    if valid_kv is not None and valid_kv < k.shape[1]:
        p = p * (torch.arange(k.shape[1], device=q.device) < valid_kv)
    return p


def flash_batched_attention_lse_reference(q, k, v, valid_kv: Optional[int] = None, scale=None):
    """Plain version of K6: (out (B, S, H, D), lse (B, H, S) fp32)."""
    ct = _compute_dtype(q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    m = k.shape[1]
    if valid_kv is not None and valid_kv < m:
        logits = logits.masked_fill(torch.arange(m, device=q.device) >= valid_kv, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(logits - lse[..., None]), v.to(ct))
    return out.to(v.dtype), lse


def flash_batched_attention_bwd_reference(q, k, v, out, lse, dout, valid_kv: Optional[int] = None, scale=None):
    """Plain version of K7: (dq, dk, dv) by the kernel's formulas, P recomputed
    from lse. dk and dv are dense (B, M, H, D); rows >= valid_kv are 0."""
    ct = _compute_dtype(q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, out, dout))
    delta = (dof * of).sum(-1).permute(0, 2, 1)  # (B, H, S)
    p = _batched_probs(qf, kf, lse.to(ct), valid_kv, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _batched_cuda_args(name, q, k, v, valid_kv, scale):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, s, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {q.shape} k {k.shape} v {v.shape}")
    _check_cuda_inputs(name, q, k, v)
    m_valid = m if valid_kv is None else int(valid_kv)
    if not 0 < m_valid <= m:
        raise ValueError(f"{name}: valid_kv {valid_kv} outside (0, {m}]")
    return m_valid, float(d ** -0.5 if scale is None else scale)


def _batched_forward_cuda(q, k, v, valid_kv, scale, with_lse: bool):
    """Launches K1 (with_lse False) or K6; returns (out, lse or None)."""
    name = "flash_batched_attention_lse" if with_lse else "flash_batched_attention"
    m_valid, scale = _batched_cuda_args(name, q, k, v, valid_kv, scale)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, per_sm = _batched_launch_shape(q.dtype, d, with_lse)
    _, n_blocks = batched_fwd_grid(b, s, h, rows, n_sm, per_sm)
    err = load_library()[2].g2_batched_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        b, s, m_valid, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, torch.cuda.current_stream(q.device).cuda_stream, n_blocks,
    )
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return out, lse


def _row_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, heads before rows: (..., S, H, D) ->
    (..., H, S). One torch expression, as g2vlm_tpu computes it outside its
    kernels."""
    return (dout.float() * out.float()).sum(-1).transpose(-1, -2).contiguous()


def _batched_backward_cuda(q, k, v, out, lse, dout, valid_kv, scale, which=("dq", "dkv")):
    """Launches K7's dq and dkv kernels; returns (dq, dk, dv), with None for
    a part left out of `which` (the smoke times the two kernels apart)."""
    name = "flash_batched_attention_bwd"
    m_valid, scale = _batched_cuda_args(name, q, k, v, valid_kv, scale)
    b, s, h, d = q.shape
    m = k.shape[1]
    dout = dout.contiguous()
    _check_cuda_inputs(name, q, dout)
    if not out.is_contiguous() or lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: out and lse must be the forward's own outputs")
    delta = _row_delta(out, dout)
    lib = load_library()[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (_DTYPES[q.dtype], 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    dq = dk = dv = None
    if "dq" in which:
        dq = torch.empty_like(out)
        err = lib.g2_attention_bwd_dq(*common, dq.data_ptr(), None, None, None,
                                      b, s, m_valid, h, h, d, *strides, scale, stream)
        _raise_on_error(name + "_dq", err)
        launch_counts[name + "_dq"] += 1
    if "dkv" in which:
        dk = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        n_split, part = _dkv_scratch(q, m, h, h, b)
        err = lib.g2_attention_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                       part.data_ptr() if part is not None else None, n_split, None, None, None,
                                       b, s, m_valid, m, h, h, d, *strides, scale, stream)
        _raise_on_error(name + "_dkv", err)
        launch_counts[name + "_dkv"] += 1
    return dq, dk, dv


class _BatchedAttention(torch.autograd.Function):
    """K6 forward (saves q, k, v, out, lse) and K7 backward; on CPU tensors
    the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, valid_kv, scale):
        if q.device.type == "cpu":
            out, lse = flash_batched_attention_lse_reference(q, k, v, valid_kv, scale)
        else:
            out, lse = _batched_forward_cuda(q, k, v, valid_kv, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.valid_kv, ctx.scale = valid_kv, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_batched_attention_bwd_reference(q, k, v, out, lse, dout, ctx.valid_kv, ctx.scale)
        else:
            grads = _batched_backward_cuda(q, k, v, out, lse, dout, ctx.valid_kv, ctx.scale)
        # a K/V given as expand(B, ...) gets the dense (B, M, H, D) gradient:
        # autograd's expand backward sums it over the batch
        return (*grads, None, None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_batched_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, M, H, D); batch stride 0 (expand) is fine
    v: torch.Tensor,
    valid_kv: Optional[int] = None,  # keys >= valid_kv are masked
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full bidirectional (cross-)attention within each batch element.
    Returns a contiguous (B, S, H, D) tensor. An input that requires grad
    takes the lse forward (K6) and the kernel backward (K7); otherwise the
    plain forward (K1) runs."""
    if _needs_grad(q, k, v):
        return _BatchedAttention.apply(q, k, v, valid_kv, scale)
    if q.device.type == "cpu":
        return flash_batched_attention_reference(q, k, v, valid_kv, scale)
    return _batched_forward_cuda(q, k, v, valid_kv, scale, with_lse=False)[0]


# ---------------------------------------------------------------------------
# K2 / K3 / K5: packed segment-masked GQA attention, its lse forward and backward
# ---------------------------------------------------------------------------

def block_codes(q_meta: torch.Tensor, kv_meta: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(n_q, n_kv) int8 SKIP/PARTIAL/FULL codes of the (tile x tile) blocks
    from packed (S, 4) metadata, as g2vlm_tpu's `_block_codes`: FULL only when
    every pair in the block is provably visible, SKIP only when provably none
    is. q rows past S_q pad with -2 and kv rows with -1, so tail blocks are
    never FULL."""

    def stats(meta, pad_value):
        n = -(-meta.shape[0] // tile)
        padded = meta.new_full((n * tile, 4), pad_value)
        padded[: meta.shape[0]] = meta
        blocks = padded.view(n, tile, 4)
        return blocks.amin(1), blocks.amax(1)  # (n, 4) each

    q_lo, q_hi = stats(q_meta, -2)
    k_lo, k_hi = stats(kv_meta, -1)
    dq_lo, fq_lo, nq_lo, pq_lo = (x[:, None] for x in q_lo.unbind(1))
    dq_hi, fq_hi, nq_hi, pq_hi = (x[:, None] for x in q_hi.unbind(1))
    dk_lo, fk_lo, nk_lo, pk_lo = (x[None, :] for x in k_lo.unbind(1))
    dk_hi, fk_hi, nk_hi, pk_hi = (x[None, :] for x in k_hi.unbind(1))
    same_doc_all = (dq_lo == dq_hi) & (dk_lo == dk_hi) & (dq_lo == dk_lo) & (dq_lo >= 0)
    full_all = (fq_lo == fq_hi) & (fk_lo == fk_hi) & (fq_lo == fk_lo) & (fq_lo >= 0)
    causal_all = pk_hi <= pq_lo
    noise_ok_all = (nk_hi < 0) | ((nq_lo == nq_hi) & (nk_lo == nk_hi) & (nq_lo == nk_lo))
    full = same_doc_all & (full_all | causal_all) & noise_ok_all
    overlap = (dq_hi >= dk_lo) & (dk_hi >= dq_lo) & (dq_hi >= 0) & (dk_hi >= 0)
    visible_none = ~overlap | ((pk_lo > pq_hi) & ((fq_hi < 0) | (fk_hi < 0)))
    codes = torch.where(full, BLOCK_FULL, torch.where(visible_none, BLOCK_SKIP, BLOCK_PARTIAL))
    return codes.to(torch.int8).contiguous()


def segment_warpgroups(d: int, pipelined: bool = False, int8: bool = False) -> int:
    """Consumer warpgroups of a segment forward's block (csrc/attention_segment.cu): two in the
    warp-specialised schedule that K2 and K3 run at head dim 128, three in the lockstep one that K4,
    K8 and the smaller head dims run."""
    return WS_WARPGROUPS if d == WS_HEAD_DIM and not pipelined and not int8 else SEGMENT_WARPGROUPS


def segment_fwd_grid(s_q: int, h: int, kvh: int, d: int, pipelined: bool = False,
                     int8: bool = False) -> Tuple[int, int, int]:
    """(query heads of a block, query tiles of a block, blocks) of a K2 / K3 /
    K4 / K8 launch at head dim d, whose grid this is (csrc/attention_segment.cu
    `block_plan` decodes it). A block has `segment_warpgroups` consumer
    warpgroups of TILE query rows. Where the GQA group G = h / kvh is a
    multiple of them, a block holds that many query heads of one KV head on the
    same TILE token rows, so that they share its K/V stages, tile codes and
    masks, as the TPU kernel packs a group into one step; otherwise as many
    consecutive query tiles of one head. Blocks are numbered (KV head, head
    group, query tiles), the query tiles fastest."""
    wgs = segment_warpgroups(d, pipelined, int8)
    group = h // kvh
    heads = wgs if group % wgs == 0 else 1
    tiles = wgs // heads
    n_q_tiles = -(-s_q // TILE)
    return heads, tiles, -(-n_q_tiles // tiles) * kvh * (group // heads)


def segment_fwd_blocks(s_q: int, h: int, kvh: int, d: int, pipelined: bool = False,
                       int8: bool = False) -> torch.Tensor:
    """(blocks, warpgroups, 2) int64: the (query head, query tile) of each
    warpgroup of each block of `segment_fwd_grid`, as `block_plan` assigns
    them; a query tile past the last one holds no rows."""
    wgs = segment_warpgroups(d, pipelined, int8)
    heads, tiles, n_blocks = segment_fwd_grid(s_q, h, kvh, d, pipelined, int8)
    group = h // kvh
    n_tb = n_blocks // (kvh * (group // heads))  # blocks of one head group
    x = torch.arange(n_blocks)
    tb, x = x % n_tb, x // n_tb
    hg, kv_h = x % (group // heads), x // (group // heads)
    w = torch.arange(wgs)
    head = (kv_h * group + hg * heads)[:, None] + w % heads
    tile = (tb * tiles)[:, None] + w // heads
    return torch.stack([head, tile], -1)


class SegmentPlan(NamedTuple):
    """What the segment kernels read besides q, k and v: the packed (S, 4)
    int32 metadata of both sides and the tile codes."""

    q_meta: torch.Tensor
    kv_meta: torch.Tensor
    codes: torch.Tensor


def segment_plan(q_info: TokenInfo, kv_info: TokenInfo) -> Optional[SegmentPlan]:
    """The plan of a call on CUDA metadata, None on the CPU (the plain
    versions read the TokenInfo itself). Packing the metadata and classifying
    its tiles is ~20 small launches, so a forward whose layers all attend over
    one TokenInfo makes the plan once and hands it to every layer's call."""
    if q_info.doc_id.device.type == "cpu":
        return None
    q_meta = q_info.packed()
    kv_meta = q_meta if kv_info is q_info else kv_info.packed()
    return SegmentPlan(q_meta, kv_meta, block_codes(q_meta, kv_meta))


def flash_segment_attention_reference(q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None):
    """Plain version of K2: the chunked online-softmax form."""
    return segment_attention_chunked(q, k, v, q_info, kv_info, scale)


def flash_segment_attention_lse_reference(q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None):
    """Plain version of K3: (out (S_q, H, D), lse (H, S_q) fp32), lse ==
    LSE_EMPTY for a row that sees no key."""
    return segment_attention_chunked(q, k, v, q_info, kv_info, scale, return_lse=True)


def flash_segment_attention_bwd_reference(
    q, k, v, out, lse, dout, q_info: TokenInfo, kv_info: TokenInfo, scale=None, kv_chunk: int = 2048
):
    """Plain version of K5: (dq, dk, dv) by the kernel's formulas, P
    recomputed from lse, chunked over keys; dk and dv are summed over the
    GQA group."""
    ct = _compute_dtype(q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_q, h, d = q.shape
    s_kv, kvh, _ = k.shape
    g = h // kvh

    def rows(t):  # (S_q, H, ...) -> (KVH, G*S_q, ...): a KV head's G query heads stacked
        return t.reshape(s_q, kvh, g, *t.shape[2:]).permute(1, 2, 0, *range(3, t.dim() + 1)).reshape(
            kvh, g * s_q, *t.shape[2:])

    qh, doh = rows(q.to(ct)), rows(dout.to(ct))
    delta = rows((dout.to(ct) * out.to(ct)).sum(-1))  # (KVH, G*S_q)
    lse_h = lse.to(ct).reshape(kvh, g * s_q)
    # an empty row's lse is LSE_EMPTY: exp(s - lse) would overflow, the mask zeroes it first
    lse_h = torch.where(lse_h > 0.1 * LSE_EMPTY, lse_h, torch.zeros_like(lse_h))
    dq = torch.zeros_like(qh)
    dk = torch.empty((kvh, s_kv, d), dtype=ct, device=q.device)
    dv = torch.empty_like(dk)
    for c0 in range(0, s_kv, kv_chunk):
        kb = k[c0 : c0 + kv_chunk].to(ct).transpose(0, 1)  # (KVH, T, D)
        vb = v[c0 : c0 + kv_chunk].to(ct).transpose(0, 1)
        mask = make_segment_mask(q_info, kv_info.slice(c0, kb.shape[1])).repeat(g, 1)  # (G*S_q, T)
        logits = torch.matmul(qh, kb.transpose(1, 2)) * scale
        p = torch.exp(logits.masked_fill(~mask, float("-inf")) - lse_h[..., None])
        dv[:, c0 : c0 + kv_chunk] = torch.matmul(p.transpose(1, 2), doh)
        ds = p * (torch.matmul(doh, vb.transpose(1, 2)) - delta[..., None])
        dq += torch.matmul(ds, kb) * scale
        dk[:, c0 : c0 + kv_chunk] = torch.matmul(ds.transpose(1, 2), qh) * scale
    dq = dq.reshape(kvh, g, s_q, d).permute(2, 0, 1, 3).reshape(s_q, h, d)
    return dq.to(q.dtype), dk.transpose(0, 1).to(k.dtype), dv.transpose(0, 1).to(v.dtype)


def _segment_cuda_args(name, q, k, v, q_meta, kv_meta, scale):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    s_q, h, d = q.shape
    s_kv, kvh, _ = k.shape
    if k.shape != (s_kv, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"{name}: shapes q {q.shape} k {k.shape} v {v.shape}")
    _check_cuda_inputs(name, q, k, v, head_dims=SEGMENT_HEAD_DIMS)
    _check_meta(name, q, s_q, s_kv, q_meta, kv_meta)
    return float(d ** -0.5 if scale is None else scale)


def _check_meta(name, q, s_q, s_kv, q_meta, kv_meta):
    if q_meta.shape != (s_q, 4) or kv_meta.shape != (s_kv, 4):
        raise ValueError(f"{name}: metadata length differs from the sequence")
    if q_meta.device != q.device or kv_meta.device != q.device:
        raise ValueError(f"{name}: metadata must be on the inputs' device")


def _segment_forward_cuda(q, k, v, q_meta, kv_meta, codes, scale, with_lse: bool, pipelined: bool = False):
    """Launches K2 (with_lse False) or K3, or with `pipelined` K4 in either
    form; returns (out, lse or None)."""
    if pipelined:
        name = "flash_segment_attention_pipe"
    else:
        name = "flash_segment_attention_lse" if with_lse else "flash_segment_attention"
    scale = _segment_cuda_args(name, q, k, v, q_meta, kv_meta, scale)
    s_q, h, d = q.shape
    s_kv, kvh, _ = k.shape
    out = torch.empty((s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, s_q), dtype=torch.float32, device=q.device) if with_lse else None
    lib = load_library()[0]
    launch = lib.g2_segment_attention_pipe if pipelined else lib.g2_segment_attention
    err = launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        q_meta.data_ptr(), kv_meta.data_ptr(), codes.data_ptr(), s_q, s_kv, h, kvh, d,
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        scale, torch.cuda.current_stream(q.device).cuda_stream, segment_fwd_grid(s_q, h, kvh, d, pipelined)[2],
    )
    _raise_on_error(name, err)
    launch_counts[name] += 1
    if d == WS_HEAD_DIM and not pipelined:  # K2 / K3's warp-specialised schedule
        launch_counts["flash_segment_attention_ws"] += 1
    return out, lse


def _segment_backward_cuda(q, k, v, out, lse, dout, q_meta, kv_meta, codes, scale, which=("dq", "dkv")):
    """Launches K5's dq and dkv kernels on the forward's metadata and tile
    codes; returns (dq, dk, dv), None for a part left out of `which`."""
    name = "flash_segment_attention_bwd"
    scale = _segment_cuda_args(name, q, k, v, q_meta, kv_meta, scale)
    s_q, h, d = q.shape
    s_kv, kvh, _ = k.shape
    dout = dout.contiguous()
    _check_cuda_inputs(name, q, dout, head_dims=SEGMENT_HEAD_DIMS)
    if not out.is_contiguous() or lse.shape != (h, s_q) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: out and lse must be the forward's own outputs")
    if codes.shape != (-(-s_q // TILE), -(-s_kv // TILE)) or codes.dtype != torch.int8 or not codes.is_contiguous():
        raise ValueError(f"{name}: tile codes of shape {tuple(codes.shape)} do not fit the sequence")
    delta = _row_delta(out, dout)
    lib = load_library()[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (_DTYPES[q.dtype], 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    meta = (q_meta.data_ptr(), kv_meta.data_ptr(), codes.data_ptr())
    strides = (0, *q.stride()[:2], 0, *k.stride()[:2], 0, *v.stride()[:2])
    dq = dk = dv = None
    if "dq" in which:
        dq = torch.empty_like(out)
        err = lib.g2_attention_bwd_dq(*common, dq.data_ptr(), *meta,
                                      1, s_q, s_kv, h, kvh, d, *strides, scale, stream)
        _raise_on_error(name + "_dq", err)
        launch_counts[name + "_dq"] += 1
    if "dkv" in which:
        dk = torch.empty((s_kv, kvh, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        n_split, part = _dkv_scratch(q, s_kv, h, kvh, 1)
        err = lib.g2_attention_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                       part.data_ptr() if part is not None else None, n_split, *meta,
                                       1, s_q, s_kv, s_kv, h, kvh, d, *strides, scale, stream)
        _raise_on_error(name + "_dkv", err)
        launch_counts[name + "_dkv"] += 1
    return dq, dk, dv


class _SegmentAttention(torch.autograd.Function):
    """K3 forward, or with `pipelined` K4 with lse (saves q, k, v, out, lse
    and, on the card, the packed metadata and the tile codes, computed once)
    and K5 backward; on CPU tensors the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, q_info, kv_info, scale, pipelined=False, plan=None):
        if q.device.type == "cpu":
            out, lse = flash_segment_attention_lse_reference(q, k, v, q_info, kv_info, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.infos = (q_info, kv_info)
        else:
            plan = plan or segment_plan(q_info, kv_info)
            out, lse = _segment_forward_cuda(q, k, v, *plan, scale, with_lse=True, pipelined=pipelined)
            ctx.save_for_backward(q, k, v, out, lse, *plan)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *meta = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_segment_attention_bwd_reference(q, k, v, out, lse, dout, *ctx.infos, ctx.scale)
        else:
            grads = _segment_backward_cuda(q, k, v, out, lse, dout, *meta, ctx.scale)
        return (*grads, None, None, None, None, None)


def flash_segment_attention(
    q: torch.Tensor,  # (S_q, H, D)
    k: torch.Tensor,  # (S_kv, KVH, D)
    v: torch.Tensor,
    q_info: TokenInfo,
    kv_info: TokenInfo,
    scale: Optional[float] = None,
    pipelined: bool = False,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """Packed segment-masked GQA attention. Returns a contiguous (S_q, H, D)
    tensor; rows with no visible key are 0. An input that requires grad takes
    the lse forward (K3) and the kernel backward (K5); otherwise the plain
    forward (K2) runs. `pipelined` selects the two-stage schedule (K4) for the
    forward in either case; it computes the same function, so on CPU tensors
    it changes nothing. `plan` is `segment_plan(q_info, kv_info)` when the
    caller already has it; without it the call makes its own."""
    if _needs_grad(q, k, v):
        return _SegmentAttention.apply(q, k, v, q_info, kv_info, scale, pipelined, plan)
    if q.device.type == "cpu":
        return flash_segment_attention_reference(q, k, v, q_info, kv_info, scale)
    plan = plan or segment_plan(q_info, kv_info)
    return _segment_forward_cuda(q, k, v, *plan, scale, with_lse=False, pipelined=pipelined)[0]


def _mla_forward_cuda(q, k, v, q_meta, kv_meta, codes, scale):
    name = "flash_mla_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    s_q, h, dqk = q.shape
    s_kv, kvh, dv = v.shape
    if (dqk, dv) != MLA_HEAD_DIMS or k.shape != (s_kv, kvh, dqk) or h % kvh:
        raise ValueError(f"{name}: shapes q {q.shape} k {k.shape} v {v.shape}; the kernel takes "
                         f"(QK, V) head dims {MLA_HEAD_DIMS}")
    _check_cuda_inputs(name, q, k, v, head_dims=(dqk,))
    _check_meta(name, q, s_q, s_kv, q_meta, kv_meta)
    out = torch.empty((s_q, h, dv), dtype=q.dtype, device=q.device)
    err = load_library()[0].g2_mla_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_meta.data_ptr(), kv_meta.data_ptr(), codes.data_ptr(), s_q, s_kv, h, kvh, dqk, dv,
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        float(dqk ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
        segment_fwd_grid(s_q, h, kvh, WS_HEAD_DIM)[2],  # K2's warp-specialised block
    )
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return out


def flash_mla_attention(
    q: torch.Tensor,  # (S_q, H, 192): each head's 128 nope columns, then its 64 roped ones
    k: torch.Tensor,  # (S_kv, KVH, 192)
    v: torch.Tensor,  # (S_kv, KVH, 128)
    q_info: TokenInfo,
    kv_info: TokenInfo,
    scale: Optional[float] = None,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """The MLA forward (inference only): K2's segment-masked attention where the queries and keys
    are wider than the values. Returns a contiguous (S_q, H, 128) tensor; rows with no visible key
    are 0; the default scale is 192^-0.5. On CPU tensors the plain chunked version runs."""
    if q.device.type == "cpu":
        return segment_attention_chunked(q, k, v, q_info, kv_info, scale)
    plan = plan or segment_plan(q_info, kv_info)
    return _mla_forward_cuda(q, k, v, *plan, scale)


# ---------------------------------------------------------------------------
# K8: segment attention with an int8 QK^T product (inference only)
# ---------------------------------------------------------------------------

_LOG2E = 1.4426950408889634


def _hadamard(d: int) -> torch.Tensor:
    """Normalised Sylvester-Hadamard matrix (d a power of two), fp32."""
    h = torch.ones((1, 1), dtype=torch.float32)
    while h.shape[0] < d:
        h = torch.cat([torch.cat([h, h], dim=1), torch.cat([h, -h], dim=1)], dim=0)
    return h * (d ** -0.5)


def quantize_qk(
    q: torch.Tensor,  # (S_q, H, D)
    k: torch.Tensor,  # (S_kv, KVH, D)
    kv_meta: torch.Tensor,  # (S_kv, 4) int32 packed kv metadata: doc < 0 marks padding keys
    scale: Optional[float] = None,
    hadamard: bool = True,
    kmean: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantiser of K8, plain tensor code as in g2vlm_tpu's `_flash_int8`:
    per-token symmetric int8 for q and k. With `kmean` the per-(kv head,
    channel) mean of the real keys is subtracted first (every score of a query
    row shifts by the same amount, which the softmax cancels); with
    `hadamard`, when D is a power of two, both are rotated by a normalised
    Hadamard matrix ((qH)(kH)^T == qk^T) to spread outlier channels. Scales
    are absmax / 127 floored at 1e-6 / 127.

    Returns q8 (S_q, H, DP) int8, qs (H, S_q) fp32 folded with
    scale * log2(e), k8 (S_kv, KVH, DP) int8 and ks (KVH, S_kv) fp32, with DP
    the head dim rounded up to 32 (the kernel's k-step) and zeros past D."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    qf, kf = q.float(), k.float()
    if kmean:
        real = (kv_meta[:, 0] >= 0).float()
        denom = real.sum().clamp_min(1.0)
        kf = kf - (kf * real[:, None, None]).sum(0, keepdim=True) / denom
    if hadamard and d & (d - 1) == 0:
        had = _hadamard(d).to(q.device)
        qf, kf = qf @ had, kf @ had
    dp = -(-d // 32) * 32

    def quant(x):
        s = x.abs().amax(-1).clamp_min(1e-6) / 127.0  # (S, heads)
        x8 = torch.round(x / s[..., None]).to(torch.int8)
        if dp != d:
            x8 = torch.nn.functional.pad(x8, (0, dp - d))
        return x8.contiguous(), s

    q8, qscale = quant(qf)
    k8, kscale = quant(kf)
    qs = (qscale * (scale * _LOG2E)).T.contiguous()
    return q8, qs, k8, kscale.T.contiguous()


def _int8_attention_plain(q8, qs, k8, ks, v, q_info: TokenInfo, kv_info: TokenInfo, kv_chunk: int = 2048):
    """K8's arithmetic in plain tensor code: an exact integer QK^T (int8
    products summed in fp32 stay below 2^24, so the fp32 product is exact),
    row scale then column scale, the segment mask, an fp32 exp2 softmax with
    the running max, P rounded to v's type when that is bf16 or fp16, P.V."""
    s_q, h, _ = q8.shape
    s_kv, kvh, d = v.shape
    g = h // kvh
    round_p = v.dtype in _DTYPES
    qh = q8.float().reshape(s_q, kvh, g, -1).permute(1, 2, 0, 3).reshape(kvh, g * s_q, -1)
    qs_h = qs.reshape(kvh, g * s_q)
    m = torch.full((kvh, g * s_q), float("-inf"), device=v.device)
    l = torch.zeros((kvh, g * s_q), device=v.device)
    acc = torch.zeros((kvh, g * s_q, d), device=v.device)
    for c0 in range(0, s_kv, kv_chunk):
        kb = k8[c0 : c0 + kv_chunk].float().transpose(0, 1)  # (KVH, T, DP)
        vb = v[c0 : c0 + kv_chunk].float().transpose(0, 1)
        mask = make_segment_mask(q_info, kv_info.slice(c0, kb.shape[1])).repeat(g, 1)  # (G*S_q, T)
        logits = torch.matmul(qh, kb.transpose(1, 2)) * qs_h[..., None] * ks[:, None, c0 : c0 + kv_chunk]
        logits = logits.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, logits.amax(-1))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        p = torch.exp2(logits - m_use[..., None])
        alpha = torch.exp2(m - m_use)
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.to(v.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(kvh, g, s_q, d).permute(2, 0, 1, 3).reshape(s_q, h, d).to(v.dtype)


def flash_segment_attention_int8_reference(
    q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None, hadamard: bool = True, kmean: bool = True
):
    """Plain version of K8: the same quantiser, then `_int8_attention_plain`."""
    q8, qs, k8, ks = quantize_qk(q, k, kv_info.packed(), scale, hadamard, kmean)
    return _int8_attention_plain(q8, qs, k8, ks, v, q_info, kv_info)


def _int8_launch_grid(q8, qs, k8, ks, v, q_meta, kv_meta, codes) -> int:
    """The checks `_int8_forward_cuda` makes before it launches K8, on any
    device: shapes, dtypes, contiguity and alignment of the quantised operands,
    the (heads, rows) scales, the metadata and the tile codes. Returns the
    launch's grid, `segment_fwd_grid`'s."""
    name = "flash_segment_attention_int8"
    s_q, h, dp = q8.shape
    s_kv, kvh, d = v.shape
    if k8.shape != (s_kv, kvh, dp) or dp != -(-d // 32) * 32 or h % kvh:
        raise ValueError(f"{name}: shapes q8 {q8.shape} k8 {k8.shape} v {v.shape}")
    _check_cuda_inputs(name, v, head_dims=SEGMENT_HEAD_DIMS)
    for t, shape in ((q8, None), (k8, None), (qs, (h, s_q)), (ks, (kvh, s_kv))):
        want = torch.int8 if shape is None else torch.float32
        if t.dtype != want or t.device != v.device or not t.is_contiguous() or (shape and t.shape != shape):
            raise ValueError(f"{name}: q8/k8 must be contiguous int8 and qs/ks contiguous fp32 of (heads, rows)")
    if q8.data_ptr() % 16 or k8.data_ptr() % 16:
        raise ValueError(f"{name}: q8 and k8 must start 16-byte aligned")
    _check_meta(name, v, s_q, s_kv, q_meta, kv_meta)
    n_tiles = (-(-s_q // TILE), -(-s_kv // TILE))
    if (codes.shape != n_tiles or codes.dtype != torch.int8 or not codes.is_contiguous()
            or codes.device != v.device):
        raise ValueError(f"{name}: tile codes of shape {tuple(codes.shape)} do not fit the sequence")
    return segment_fwd_grid(s_q, h, kvh, d, int8=True)[2]


def _int8_forward_cuda(q8, qs, k8, ks, v, q_meta, kv_meta, codes):
    """Launches K8 on quantised inputs; returns out (S_q, H, D) in v's type."""
    name = "flash_segment_attention_int8"
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    n_blocks = _int8_launch_grid(q8, qs, k8, ks, v, q_meta, kv_meta, codes)
    s_q, h, dp = q8.shape
    s_kv, kvh, d = v.shape
    out = torch.empty((s_q, h, d), dtype=v.dtype, device=v.device)
    err = load_library()[0].g2_segment_attention_int8(
        _DTYPES[v.dtype], q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
        qs.data_ptr(), ks.data_ptr(), q_meta.data_ptr(), kv_meta.data_ptr(), codes.data_ptr(),
        s_q, s_kv, h, kvh, d, dp,
        *q8.stride()[:2], *k8.stride()[:2], *v.stride()[:2],
        torch.cuda.current_stream(v.device).cuda_stream, n_blocks,
    )
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return out


def flash_segment_attention_int8(
    q: torch.Tensor,  # (S_q, H, D)
    k: torch.Tensor,  # (S_kv, KVH, D)
    v: torch.Tensor,
    q_info: TokenInfo,
    kv_info: TokenInfo,
    scale: Optional[float] = None,
    hadamard: bool = True,
    kmean: bool = True,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """K2's function with QK^T as an int8 product on per-token scales (K8):
    the quantized serving mode's prefill attention. Inference only: the
    quantiser rounds, so an input that requires grad raises instead of
    training through quantisation noise."""
    if _needs_grad(q, k, v):
        raise RuntimeError("flash_segment_attention_int8 has no gradient: train through flash_segment_attention")
    if q.device.type == "cpu":
        return flash_segment_attention_int8_reference(q, k, v, q_info, kv_info, scale, hadamard, kmean)
    plan = plan or segment_plan(q_info, kv_info)
    q8, qs, k8, ks = quantize_qk(q, k, plan.kv_meta, scale, hadamard, kmean)
    return _int8_forward_cuda(q8, qs, k8, ks, v, *plan)
