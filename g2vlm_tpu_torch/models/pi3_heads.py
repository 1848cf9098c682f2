"""Pi3 3D heads reading the LLM hidden states (port of
g2vlm_tpu/models/pi3_heads.py).

Submodule names follow the reference key space (`point_decoder.blocks.{i}.
attn.qkv`, `global_points_decoder.blocks.{i}.cross_attn.q_proj`,
`camera_head.more_mlps.{0,2}`, ...). The point and camera decoders run as two
plain decoders; all their attention, and the global decoder's cross attention
to frame 0 (batch-1 K/V expanded with batch stride 0), goes through the
batched attention kernel. The point and camera heads run in fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Pi3HeadConfig

from ..ops.flash_attention import flash_batched_attention
from ..ops.linear import linear
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope2d_bshd, rope2d_cos_sin


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class CrossAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return linear(F.gelu(linear(x, self.fc1, dt)), self.fc2, dt)


class Block(nn.Module):
    def __init__(self, d: int, cfg: Pi3HeadConfig, cross: bool):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = SelfAttention(d)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        if cross:
            self.norm_y = nn.LayerNorm(d, eps=eps)
            self.cross_attn = CrossAttention(d)
            self.norm3 = nn.LayerNorm(d, eps=eps)


class Decoder(nn.Module):
    """Pi3TransformerDecoder, or with `cross` the context decoder."""

    def __init__(self, cfg: Pi3HeadConfig, d: int, out_dim: int, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        self.blocks = nn.ModuleList(Block(d, cfg, cross) for _ in range(cfg.depth))
        self.linear_out = nn.Linear(d, out_dim)


class LinearPts3d(nn.Module):
    def __init__(self, dec_dim: int, patch_size: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(dec_dim, out_dim * patch_size * patch_size)


class ResConvBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.res_conv1 = nn.Linear(d, d)
        self.res_conv2 = nn.Linear(d, d)
        self.res_conv3 = nn.Linear(d, d)


class CameraHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.res_conv = nn.ModuleList(ResConvBlock(d) for _ in range(2))
        self.more_mlps = nn.Sequential(nn.Linear(d, d), nn.ReLU(), nn.Linear(d, d), nn.ReLU())
        self.fc_t = nn.Linear(d, 3)
        self.fc_rot = nn.Linear(d, 9)


def patch_positions(n: int, hp: int, wp: int, device=None) -> torch.Tensor:
    """(n, hp*wp, 2) int32 (y, x) patch coordinates."""
    grid = np.stack(np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij"), axis=-1)
    grid = torch.as_tensor(grid.reshape(-1, 2).astype(np.int32), device=device)
    return grid[None].expand(n, hp * wp, 2)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.view(b, s, num_heads, d // num_heads)


def _self_attn(x, attn: SelfAttention, cos, sin, num_heads):
    b, s, d = x.shape
    q, k, v = linear(x, attn.qkv, x.dtype).split(d, dim=-1)
    q = apply_rope2d_bshd(_heads(q, num_heads), cos, sin)
    k = apply_rope2d_bshd(_heads(k, num_heads), cos, sin)
    v = _heads(v, num_heads)
    out = flash_batched_attention(q, k, v).reshape(b, s, d)
    return linear(out, attn.proj, x.dtype)


def _cross_attn(x, y, attn: CrossAttention, cos_q, sin_q, cos_k, sin_k, num_heads):
    """y may carry batch 1 against x's batch B (frame-0 context): its K/V
    projections and rope run once and are expanded with batch stride 0."""
    b, s, d = x.shape
    dt = x.dtype
    q = apply_rope2d_bshd(_heads(linear(x, attn.q_proj, dt), num_heads), cos_q, sin_q)
    k = apply_rope2d_bshd(_heads(linear(y, attn.k_proj, dt), num_heads), cos_k, sin_k)
    v = _heads(linear(y, attn.v_proj, dt), num_heads)
    if y.shape[0] == 1 and b > 1:
        k = k.expand(b, -1, -1, -1)
        v = v.expand(b, -1, -1, -1)
    out = flash_batched_attention(q, k, v).reshape(b, s, d)
    return linear(out, attn.proj, dt)


def _ln(x, norm: nn.LayerNorm):
    return layer_norm(x, norm.weight, norm.bias, norm.eps)


def decoder_forward(
    dec: Decoder,
    hidden: torch.Tensor,  # (N, hw, D)
    positions: torch.Tensor,  # (N, hw, 2)
    context: Optional[torch.Tensor] = None,  # (1 or N, hw_ctx, D) for the cross decoder
    context_positions: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Blocks then linear_out; runs in `compute_dtype` (default: the dtype of
    the decoder's parameters). With `remat` every block is recomputed in the
    backward."""
    cfg = dec.cfg
    d = hidden.shape[-1]
    hd = d // cfg.num_heads
    dt = compute_dtype or dec.linear_out.weight.dtype
    cos, sin = rope2d_cos_sin(positions, hd, cfg.rope_freq)
    ctx = cos_k = sin_k = None
    if context is not None:
        cos_k, sin_k = rope2d_cos_sin(context_positions, hd, cfg.rope_freq)
        ctx = context.to(dt)

    def block(blk, x, ctx):
        x = x + _self_attn(_ln(x, blk.norm1), blk.attn, cos, sin, cfg.num_heads)
        if ctx is not None:
            y = _ln(ctx, blk.norm_y)
            h = _ln(x, blk.norm2)
            x = x + _cross_attn(h, y, blk.cross_attn, cos, sin, cos_k, sin_k, cfg.num_heads)
            h = _ln(x, blk.norm3)
        else:
            h = _ln(x, blk.norm2)
        return x + blk.mlp(h)

    x = hidden.to(dt)
    for blk in dec.blocks:
        x = checkpoint(block, blk, x, ctx, use_reentrant=False) if remat else block(blk, x, ctx)
    return linear(x, dec.linear_out, dt)


def _lin32(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.float(), lin.bias.float())


def linear_pts3d(head: LinearPts3d, tokens: torch.Tensor, img_hw, patch_size: int) -> torch.Tensor:
    """Pixel-shuffle point head, fp32: tokens (B, S, D) -> (B, H, W, out_dim)."""
    h, w = img_hw
    p = patch_size
    b = tokens.shape[0]
    feat = _lin32(tokens.float(), head.proj)  # (B, S, C*p*p)
    c = feat.shape[-1] // (p * p)
    feat = feat.reshape(b, h // p, w // p, c, p, p)
    return feat.permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, c)


def svd_orthogonalize(m: torch.Tensor) -> torch.Tensor:
    """9D -> SO(3) via SVD, fp32: r = V' U^T where U S V^T = normalize(m)^T and
    V' has its last column flipped by det(V U^T). The result does not depend
    on the SVD's sign choices (U and V flip together)."""
    m = m.reshape(-1, 3, 3).float()
    norm = torch.linalg.norm(m, dim=-1, keepdim=True)
    m_t = (m / norm.clamp_min(1e-12)).transpose(-1, -2)
    u, _, vh = torch.linalg.svd(m_t, full_matrices=False)
    v = vh.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    v_fixed = torch.cat([v[..., :-1], v[..., -1:] * det[:, None, None]], dim=-1)
    return v_fixed @ ut


def camera_head(head: CameraHead, feat: torch.Tensor) -> torch.Tensor:
    """feat (N, hw, C) -> (N, 4, 4) SE(3) poses, fp32."""
    n = feat.shape[0]
    x = feat.float()
    for blk in head.res_conv:
        h = F.relu(_lin32(x, blk.res_conv1))
        h = F.relu(_lin32(h, blk.res_conv2))
        h = F.relu(_lin32(h, blk.res_conv3))
        x = x + h
    x = x.mean(dim=1)
    x = F.relu(_lin32(x, head.more_mlps[0]))
    x = F.relu(_lin32(x, head.more_mlps[2]))
    t = _lin32(x, head.fc_t)
    rot = svd_orthogonalize(_lin32(x, head.fc_rot))
    pose = torch.zeros((n, 4, 4), dtype=torch.float32, device=feat.device)
    pose[:, :3, :3] = rot
    pose[:, :3, 3] = t
    pose[:, 3, 3] = 1.0
    return pose
