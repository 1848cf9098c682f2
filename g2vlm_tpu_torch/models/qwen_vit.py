"""Qwen2-VL vision tower, the semantic encoder of the chat path (port of
g2vlm_tpu/models/qwen_vit.py).

Submodule names follow the reference key space under `vit_model.`
(`patch_embed.proj.weight` (D, C, 2, 14, 14), `blocks.{i}.norm1 / attn.qkv /
attn.proj / norm2 / mlp.fc1 / mlp.fc2`, `merger.ln_q`, `merger.mlp.0 / .2`),
which are the keys g2vlm_tpu's `qwen_vit.params_from_torch` reads.

The Conv3d patch embed with kernel == stride is one matrix product over the
image processor's flattened patch rows. Rotary (h, w) coords follow the
merge-permuted token order, so the 2x2 PatchMerger is a reshape of 4
consecutive rows. `encode` is the uniform-grid form (dense attention per
temporal frame, plain tensor code as in the JAX package); `encode_packed`
takes several images of any grids concatenated, each image an attention
segment of the segment kernel at head dim 80 (K2, or K4 / K8 by the serving
options; in training, with `remat`, K3 forwards and K5 backwards).
`packed_row_chunks`, `pack_views` and `merge_permuted_hw_coords` are host
numpy, the port's own copies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import VitConfig
from ..ops.attention import dense_attention, self_attender
from ..ops.linear import linear
from ..ops.masks import TokenInfo
from ..ops.norms import layer_norm
from ..ops.rope import apply_vision_rope, vision_rope_cos_sin

LN_EPS = 1e-6


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(name)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        kernel = (cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_channels, cfg.embed_dim, kernel, stride=kernel, bias=False)


class VisionAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class VisionMlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = VisionAttention(d)
        self.mlp = VisionMlp(d, int(d * cfg.mlp_ratio))


class PatchMerger(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        merge_dim = cfg.embed_dim * cfg.spatial_merge_size ** 2
        self.ln_q = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(merge_dim, merge_dim), nn.GELU(), nn.Linear(merge_dim, cfg.hidden_size))


class QwenVit(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg)


def merge_permuted_hw_coords(grid_thw: Tuple[int, int, int]) -> np.ndarray:
    """(h, w) coords per token in the image processor's merge-grouped order."""
    t, h, w = grid_thw
    m = 2  # spatial_merge_size
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def perm(x):
        return x.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    coords = np.stack([perm(hpos), perm(wpos)], axis=-1)  # (h*w, 2)
    return np.tile(coords, (t, 1))


def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, ln.weight, ln.bias, LN_EPS)


def _block(blk: VisionBlock, x: torch.Tensor, cos, sin, attend, cfg: VitConfig, dt: torch.dtype) -> torch.Tensor:
    s = x.shape[0]
    d, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    qkv = linear(_norm(x, blk.norm1), blk.attn.qkv, dt).view(s, 3, nh, hd)
    q, k = apply_vision_rope(qkv[:, 0], qkv[:, 1], cos, sin)
    attn = attend(q, k, qkv[:, 2])
    x = x + linear(attn.reshape(s, d), blk.attn.proj, dt)
    m = _act(linear(_norm(x, blk.norm2), blk.mlp.fc1, dt), cfg.hidden_act)
    return x + linear(m, blk.mlp.fc2, dt)


def _tower(model: QwenVit, patches: torch.Tensor, cos, sin, attend, dt: torch.dtype, remat: bool = False):
    """Patch embed, the blocks with `attend(q, k, v) -> (S, H, hd)`, the merger.
    With `remat` each block is recomputed in the backward instead of keeping
    its activations (a 32-block tower at 23,328 rows does not keep them)."""
    cfg = model.cfg
    s = patches.shape[0]
    d = cfg.embed_dim
    x = F.linear(patches.to(dt), model.patch_embed.proj.weight.reshape(d, -1).to(dt))
    for blk in model.blocks:
        if remat:
            x = checkpoint(_block, blk, x, cos, sin, attend, cfg, dt, use_reentrant=False)
        else:
            x = _block(blk, x, cos, sin, attend, cfg, dt)
    x = _norm(x, model.merger.ln_q).reshape(s // 4, 4 * d)
    return linear(F.gelu(linear(x, model.merger.mlp[0], dt)), model.merger.mlp[2], dt)


def encode(
    model: QwenVit,
    patches: torch.Tensor,  # (S, C*tps*ps*ps) flattened patch rows
    grid_thw: Tuple[int, int, int],
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One uniform grid -> (S // 4, hidden_size) merged image tokens; dense
    attention within each temporal frame."""
    t, h, w = grid_thw
    cfg = model.cfg
    coords = torch.from_numpy(merge_permuted_hw_coords(grid_thw)).to(patches.device)
    cos, sin = vision_rope_cos_sin(coords, cfg.head_dim)

    def attend(q, k, v):
        shape = (t, h * w, cfg.num_heads, cfg.head_dim)
        return dense_attention(q.view(shape), k.view(shape), v.view(shape))

    return _tower(model, patches, cos, sin, attend, compute_dtype)


def encode_packed(
    model: QwenVit,
    patches: torch.Tensor,  # (P, pdim) rows of several images, concatenated
    coords: torch.Tensor,  # (P, 2) merge-permuted (h, w) rope coords
    seg_id: torch.Tensor,  # (P,) image index per row; -1 = padding
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    attn_pipe: bool = False,
    row_chunks: int = 1,
    remat: bool = False,
) -> torch.Tensor:
    """Packed multi-image encode: each image is an attention segment, so any
    per-image grids share one call. Returns (P // 4, hidden_size) merged
    tokens in image order; rows of padding segments are garbage and callers
    drop them. `remat` recomputes each block in the backward (training).

    row_chunks > 1 runs the whole tower on P / row_chunks-row slices, one
    after another: images never attend across each other, so any
    image-aligned split is exact while the live activations shrink by the
    chunk factor. Callers pick boundaries that split no segment
    (`packed_row_chunks`)."""
    p_tot = patches.shape[0]
    if row_chunks > 1:
        if p_tot % row_chunks:
            raise ValueError(f"{p_tot} patch rows do not split into {row_chunks} chunks")
        rpc = p_tot // row_chunks
        return torch.cat([
            encode_packed(model, patches[i : i + rpc], coords[i : i + rpc], seg_id[i : i + rpc],
                          compute_dtype, attn_impl, attn_pipe, remat=remat)
            for i in range(0, p_tot, rpc)
        ], dim=0)
    cos, sin = vision_rope_cos_sin(coords, model.cfg.head_dim)
    seg = seg_id.to(torch.int32)
    # full bidirectional attention within each image, none across
    info = TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(p_tot, dtype=torch.int32, device=seg.device))
    return _tower(model, patches, cos, sin, self_attender(info, attn_impl, attn_pipe), compute_dtype, remat)


def packed_row_chunks(seg_id, max_rows: int = 16384) -> int:
    """The smallest chunk count whose equal row slices are <= max_rows, split
    no segment and keep the 4-row merge groups whole; 1 when the layout
    already fits or no clean split exists. Host-side."""
    seg = np.asarray(seg_id)
    p = len(seg)
    if p <= max_rows:
        return 1
    for c in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64):
        if p % c:
            continue
        rpc = p // c
        if rpc > max_rows or rpc % 4:
            continue
        bounds = np.arange(1, c) * rpc
        if all(seg[b - 1] != seg[b] or seg[b] < 0 for b in bounds):
            return c
    return 1


def pack_views(views, pad_to: int = 0, patch_dim: int = 1176):
    """Host-side packing of [{'patches', 'grid_thw'}, ...] into the
    encode_packed inputs: (patches (P, pdim), coords (P, 2), seg_id (P,),
    n_merged_real). P = pad_to if given (padding rows get seg_id -1)."""
    if views:
        pats = np.concatenate([np.asarray(v["patches"], np.float32) for v in views])
        coords = np.concatenate([merge_permuted_hw_coords(tuple(v["grid_thw"])) for v in views])
        seg = np.concatenate([np.full(int(np.prod(v["grid_thw"])), i, np.int32) for i, v in enumerate(views)])
        patch_dim = pats.shape[1]
    else:
        pats = np.zeros((0, patch_dim), np.float32)
        coords = np.zeros((0, 2), np.int64)
        seg = np.zeros((0,), np.int32)
    n = pats.shape[0]
    if pad_to:
        if n > pad_to:
            raise ValueError(f"{n} patch rows exceed pad_to {pad_to}")
        pats = np.concatenate([pats, np.zeros((pad_to - n, pats.shape[1]), np.float32)])
        coords = np.concatenate([coords, np.zeros((pad_to - n, 2), coords.dtype)])
        seg = np.concatenate([seg, np.full(pad_to - n, -1, np.int32)])
    return pats, coords, seg, n // 4
