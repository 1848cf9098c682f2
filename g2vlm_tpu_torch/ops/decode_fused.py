"""The MoT decode step's two fused kernels (csrc/decode_fused.cu), their
wrappers, plain versions and launch counters.

`decode_attention` is a layer's chain between the q/k/v and the o products of
`inference/decoding._decode_step`: the fresh rows' q/k RMSNorm (qk_norm), the
rotate-half RoPE of the step's angles, softmax attention of each GQA group's
queries over the cache rows below `length` plus the token's own row, and the
store of the roped k row and the v row at row `length` of the layer's cache.
`add_rms_norm` is the residual add and the RMSNorm after it. Both compute in
fp32 as the chain does and round where it rounds; the decode step takes them
for a CUDA cache in bf16 / fp16 that is whole on this rank (decoding.py).

Neither replaces a TPU kernel: the JAX package runs this path as XLA ops
(g2vlm_tpu/inference/decoding.py has no Pallas call). They exist because the
captured step was ~2,400 small kernels, ~88 a layer between its seven
products. What bounds them on the H100 is bytes and latency: at 7,100 cache
rows `decode_attention` reads 7.3 MB of one layer's cache (2.2 us at 3.35
TB/s). Its design is split rows with a last-block merge: one block per
(split of the rows, KV head, sequence), `decode_split` sizing the splits from
the capacity; blocks past `length` (read on the device) exit at once; the
last block of a (sequence, KV head), found by an atomic ticket in int32
scratch, merges the splits' softmax records with the self term, writes the
output, stores the row and resets its ticket to 0.

Dispatch: a CUDA tensor launches the kernel or the wrapper raises; a CPU
tensor takes the plain version beside the kernel, which repeats its
arithmetic (the splits, the online softmax over 128-row chunks, the merge).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import flash_attention as fa
from .rope import rotate_half

CHUNK = 128  # cache rows of a chunk (kChunk): a block's threads take one row each for the scores
HEAD_DIM = 128  # the head dim the kernel takes (kD)
MAX_GROUP = 8  # query heads of a GQA group the scratch arrays hold (kMaxG)
GROUPS = (6,)  # the GQA groups the kernel is built for (dispatch_attn's cases): the configs' 12:2 heads
MAX_SPLITS = 1024  # splits of one launch (kMaxSplits): the merge keeps each one's (m, l) in shared memory
MAX_HIDDEN = 8192  # add_rms_norm's widest row: 256 threads of 4 16-byte pieces
_W_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# Launches of each kernel; a wrapper adds one exactly where it launches (a CUDA graph's replays
# launch again without the wrapper: the decode loop's counter `decode.fused_steps` counts those).
launch_counts: Dict[str, int] = {"decode_attention": 0, "add_rms_norm": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class DecodeScratch(NamedTuple):
    """What `decode_attention` launches share: per (sequence, KV head) an int32 ticket, 0 between
    launches, and fp32 records of each split's accumulators and (m, l)."""

    ticket: torch.Tensor
    part: torch.Tensor


def decode_split(capacity: int, kv_heads: int, batch: int, n_sm: int) -> Tuple[int, int]:
    """(chunks a split, splits) of a `decode_attention` launch on a cache of `capacity` rows: one
    128-row chunk a split while the blocks of the whole capacity fit two to an SM, else as few
    more chunks a split as bring them back to that. A cache is made for its prompt plus the tokens
    and the turns to come, so the blocks of the rows in use fill the card without a second wave,
    and the merge reads one record a split."""
    chunks = -(-capacity // CHUNK)
    per_split = max(1, -(-chunks * kv_heads * batch // (2 * n_sm)))
    return per_split, -(-chunks // per_split)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    """csrc/decode_fused.cu's library (built with the attention kernels), its constants checked
    against this module's."""
    lib = fa.load_library()[3]
    got = tuple(lib.g2_decode_constants(i) for i in range(4))
    if got != (CHUNK, MAX_GROUP, MAX_SPLITS, HEAD_DIM):
        raise RuntimeError(f"decode_fused.cu: its (chunk rows, group, splits, head dim) {got} differ from "
                           f"{(CHUNK, MAX_GROUP, MAX_SPLITS, HEAD_DIM)}")
    return lib


def _record(group: int) -> int:
    """fp32 values of a split's record (kRecord): the group's accumulators and (m, l), padded to 16 bytes."""
    return -(-group * (HEAD_DIM + 2) // 4) * 4


def decode_scratch(batch: int, kv_heads: int, group: int, capacity: int, device) -> DecodeScratch:
    """The scratch of `decode_attention` launches on caches of `capacity` rows, for every layer of a
    step: each launch leaves the tickets at 0. On the CPU (the plain version) it is not read."""
    device = torch.device(device)
    n_split = decode_split(capacity, kv_heads, batch, _sm_count(device))[1] if device.type == "cuda" else 1
    return DecodeScratch(torch.zeros(batch * kv_heads, dtype=torch.int32, device=device),
                         torch.empty(batch * kv_heads * n_split * _record(group), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _norm_rope(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float, cos, sin) -> torch.Tensor:
    """(B, heads, D) -> fp32: the chain's `rms_norm(x.float(), weight, eps)` when weighted, then
    `apply_mrope`'s rotation, rounded to x's dtype without the norm (apply_mrope returns its
    input's dtype)."""
    xf = x.float()
    if weight is not None:
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float()
    y = xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]
    return y if weight is not None else y.to(x.dtype).float()


def decode_attention_plain(
    q, k, v, cos, sin, k_cache, v_cache, length, q_norm=None, k_norm=None, eps: float = 1e-6,
    chunks_per_split: int = 1,
) -> torch.Tensor:
    """The arithmetic of `decode_attention` in plain PyTorch (fp32): per sequence the rows below
    min(length, capacity) in splits of `chunks_per_split` 128-row chunks (split 0 even with no
    row), an online softmax over each split's chunks, then the merge of the splits' (m, l, acc)
    with the token's own row; the row stored at min(length, capacity - 1) afterwards. Returns
    (B, H D) in q's dtype; the caches are written in place."""
    b, nh, d = q.shape
    kvh, cap = k.shape[1], k_cache.shape[2]
    g = nh // kvh
    scale = d ** -0.5
    qf = _norm_rope(q, q_norm, eps, cos, sin).view(b, kvh, g, d)
    kf = _norm_rope(k, k_norm, eps, cos, sin)  # (B, KVH, D)
    vf = v.float()
    span = CHUNK * chunks_per_split
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    for bi, ln in enumerate(length.tolist()):
        n = min(ln, cap)
        ms, ls, accs = [], [], []
        for r0 in range(0, max(n, 1), span):
            m = torch.full((kvh, g), float("-inf"), device=q.device)
            l = torch.zeros((kvh, g), device=q.device)
            acc = torch.zeros((kvh, g, d), device=q.device)
            for c0 in range(r0, min(n, r0 + span), CHUNK):
                c1 = min(n, c0 + CHUNK)
                s = torch.einsum("hgd,hrd->hgr", qf[bi], k_cache[bi, :, c0:c1].float()) * scale
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hgr,hrd->hgd", p, v_cache[bi, :, c0:c1].float())
                m = m_new
            ms.append(m), ls.append(l), accs.append(acc)
        ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)  # (S, KVH, G[, D])
        s_self = torch.einsum("hgd,hd->hg", qf[bi], kf[bi]) * scale
        mm = torch.maximum(ms.amax(0), s_self)
        w = torch.exp(ms - mm)
        p_self = torch.exp(s_self - mm)
        l_all = (ls * w).sum(0) + p_self
        acc_all = (accs * w[..., None]).sum(0) + p_self[..., None] * vf[bi][:, None, :]
        out[bi] = acc_all / l_all.clamp_min(1e-30)[..., None]
    pos = length.clamp(max=cap - 1)
    bi = torch.arange(b, device=q.device)
    k_cache[bi, :, pos] = kf.to(k_cache.dtype)
    v_cache[bi, :, pos] = v.to(v_cache.dtype)
    return out.reshape(b, nh * d).to(q.dtype)


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor, eps: float):
    """The arithmetic of `add_rms_norm`: (x + delta rounded to x's dtype, or x itself without a
    delta; its RMSNorm, y = sum * rsqrt(mean(sum^2) + eps) rounded to the dtype, then times the
    weight in fp32, rounded again)."""
    s = x if delta is None else (x.float() + delta.float()).to(x.dtype)
    sf = s.float()
    y = sf * torch.rsqrt(sf.square().sum(-1, keepdim=True) / sf.shape[-1] + eps)
    return s, (weight.float() * y.to(x.dtype).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_rows(name: str, dtype: torch.dtype, device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: inputs on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype} here, got {t.dtype} (bf16 or fp16 throughout; "
                            f"the int8 cache runs decoding.py's chain)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}, strides {t.stride()}")


def _check_weights(name: str, d: int, device: torch.device, *weights: torch.Tensor) -> int:
    """The weights' dtype code; raises on a weight the kernel does not take."""
    w_dtypes = set()
    for w in weights:
        if w.shape != (d,) or not w.is_contiguous() or w.dtype not in _W_DTYPES or w.device != device:
            raise ValueError(f"{name}: a norm weight must be a contiguous ({d},) bf16 / fp16 / fp32 tensor on the "
                             f"inputs' device, got {tuple(w.shape)} {w.dtype} on {w.device}")
        w_dtypes.add(w.dtype)
    if len(w_dtypes) > 1:
        raise TypeError(f"{name}: norm weights of dtypes {sorted(map(str, w_dtypes))}")
    return _W_DTYPES[weights[0].dtype]


def decode_attention(
    q: torch.Tensor,  # (B, H, D): the step's q projection, bias added, in the compute dtype
    k: torch.Tensor,  # (B, KVH, D)
    v: torch.Tensor,  # (B, KVH, D)
    cos: torch.Tensor,  # (B, D) fp32: the step's rope angles
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # the layer's (B, KVH, C, D), rows contiguous
    v_cache: torch.Tensor,
    length: torch.Tensor,  # (B,) int64: the valid rows of each sequence's cache, read on the device
    q_norm: Optional[torch.Tensor] = None,  # (D,) qk_norm weights, both or neither
    k_norm: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    scratch: Optional[DecodeScratch] = None,
) -> torch.Tensor:
    """One decode step's attention of a layer (see the module docstring); stores the layer's new
    k / v rows at min(length, C - 1) in place. Returns (B, H D) in the compute dtype. `scratch`
    (`decode_scratch`) may be shared by every layer of a step; without it each call makes its
    own."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cos, sin, k_cache, v_cache, length, q_norm, k_norm, eps)
    name = "decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if k_cache.dtype not in fa._DTYPES:
        raise TypeError(f"{name}: the kernel reads a bf16 or fp16 cache, got {k_cache.dtype} (the int8 cache runs "
                        f"decoding.py's chain)")
    b, nh, d = q.shape
    kvh, cap = k_cache.shape[1], k_cache.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim {d}; the kernel takes {HEAD_DIM}")
    if (k.shape != (b, kvh, d) or v.shape != k.shape or k_cache.shape != (b, kvh, cap, d)
            or v_cache.shape != k_cache.shape or nh % kvh or nh // kvh not in GROUPS):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} (GQA groups of {GROUPS} query heads)")
    _check_rows(name, k_cache.dtype, q.device, q, k, v)
    _check_rows(name, torch.float32, q.device, cos, sin)
    if any(t.data_ptr() % 8 for t in (q, k, v)) or cos.data_ptr() % 16 or sin.data_ptr() % 16:
        raise ValueError(f"{name}: q / k / v must be 8-byte and cos / sin 16-byte aligned")
    if cos.shape != (b, d) or sin.shape != (b, d):
        raise ValueError(f"{name}: cos / sin of shapes {tuple(cos.shape)} / {tuple(sin.shape)}, expected {(b, d)}")
    for c in (k_cache, v_cache):
        if c.dtype != k_cache.dtype or c.device != q.device:
            raise ValueError(f"{name}: caches of {k_cache.dtype} / {v_cache.dtype} on {k_cache.device} / "
                             f"{v_cache.device}")
        if c.stride()[2:] != (d, 1) or c.data_ptr() % 16 or c.stride(0) % 8 or c.stride(1) % 8:
            raise ValueError(f"{name}: cache rows must be contiguous and 16-byte aligned (strides {c.stride()})")
    if k_cache.stride() != v_cache.stride():
        raise ValueError(f"{name}: K and V caches of strides {k_cache.stride()} / {v_cache.stride()}")
    if length.shape != (b,) or length.dtype != torch.int64 or length.device != q.device or not length.is_contiguous():
        raise ValueError(f"{name}: length must be a contiguous ({b},) int64 tensor on {q.device}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError(f"{name}: give both qk-norm weights or neither")
    w_dtype = 0 if q_norm is None else _check_weights(name, d, q.device, q_norm, k_norm)
    per_split, n_split = decode_split(cap, kvh, b, _sm_count(q.device))
    g = nh // kvh
    if scratch is None:
        scratch = decode_scratch(b, kvh, g, cap, q.device)
    if (scratch.ticket.numel() != b * kvh or scratch.part.numel() < b * kvh * n_split * _record(g)
            or scratch.ticket.device != q.device or scratch.part.device != q.device):
        raise ValueError(f"{name}: scratch of {scratch.ticket.numel()} tickets and {scratch.part.numel()} floats "
                         f"is not this launch's")
    out = torch.empty((b, nh * d), dtype=q.dtype, device=q.device)
    err = _lib().g2_decode_attention(
        fa._DTYPES[q.dtype], g, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_norm is None else q_norm.data_ptr(), None if k_norm is None else k_norm.data_ptr(), w_dtype,
        float(eps), cos.data_ptr(), sin.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
        out.data_ptr(), scratch.part.data_ptr(), scratch.ticket.data_ptr(), b, kvh, cap, n_split, per_split,
        q.stride(0), k.stride(0), v.stride(0), k_cache.stride(0), k_cache.stride(1), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    fa._raise_on_error(name, err)
    launch_counts[name] += 1
    return out


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor, eps: float):
    """(x + delta, rms_norm(x + delta, weight, eps)) of rows x (B, N) in the compute dtype, as the
    chain's bf16 add and `ops.norms.rms_norm` give them; without a delta, (x, rms_norm(x)). On a
    CUDA tensor one launch, one block a row."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, weight, eps)
    name = "add_rms_norm"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in fa._DTYPES:
        raise TypeError(f"{name}: the kernel takes bf16 or fp16 rows, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] % 8 or x.shape[1] > MAX_HIDDEN or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"{name}: rows of shape {tuple(x.shape)}"
                         + ("" if delta is None else f" and {tuple(delta.shape)}")
                         + f"; the kernel takes (B, N), N a multiple of 8 up to {MAX_HIDDEN}")
    _check_rows(name, x.dtype, x.device, *((x,) if delta is None else (x, delta)))
    if x.data_ptr() % 16 or (delta is not None and delta.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    b, n = x.shape
    w_dtype = _check_weights(name, n, x.device, weight)
    y = torch.empty_like(x)
    s = x if delta is None else torch.empty_like(x)
    err = _lib().g2_add_rms_norm(
        fa._DTYPES[x.dtype], x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(), w_dtype,
        s.data_ptr(), y.data_ptr(), b, n, float(eps), x.stride(0), 0 if delta is None else delta.stride(0),
        s.stride(0), y.stride(0), torch.cuda.current_stream(x.device).cuda_stream,
    )
    fa._raise_on_error(name, err)
    launch_counts[name] += 1
    return s, y
