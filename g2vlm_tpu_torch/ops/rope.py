"""Rotary position embeddings (port of g2vlm_tpu/ops/rope.py): the 3-axis
mRoPE of the LLM, the 2D axial RoPE of the Pi3 heads and the Qwen2-VL vision
RoPE of the ViT tower.

Frequency tables are built with numpy exactly as the JAX package builds them;
cos/sin and the rotation are float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def mrope_axis_map(head_dim: int, mrope_section: Sequence[int]) -> np.ndarray:
    """Per-channel axis selector of the (t, h, w) section interleave: channel
    blocks of sizes mrope_section*2 cycle through the three axes."""
    half = head_dim // 2
    if sum(mrope_section) != half:
        raise ValueError(f"mrope_section {mrope_section} does not sum to {half}")
    axes = []
    for i, sec in enumerate(list(mrope_section) * 2):
        axes.extend([i % 3] * sec)
    return np.asarray(axes, dtype=np.int64)


def mrope_cos_sin(
    position_ids: torch.Tensor,  # (3, S) int
    head_dim: int,
    theta: float,
    mrope_section: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token cos/sin of shape (S, head_dim), float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))
    dev = position_ids.device
    inv_freq2 = torch.from_numpy(np.concatenate([inv_freq, inv_freq])).to(dev)
    axis_map = torch.from_numpy(mrope_axis_map(head_dim, mrope_section)).to(dev)
    pos = position_ids.float()[axis_map, :].T  # (S, head_dim)
    ang = pos * inv_freq2[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope2d_cos_sin(
    positions: torch.Tensor,  # (B, S, 2) int — (y, x) patch coordinates
    head_dim: int,
    freq: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape (B, S, head_dim), float32: the head dim splits into a
    y-half and an x-half, each a 1D RoPE of dimension head_dim // 2."""
    half = head_dim // 2
    inv_freq = 1.0 / (freq ** (np.arange(0, half, 2, dtype=np.float32) / half))
    inv_freq = torch.from_numpy(np.concatenate([inv_freq, inv_freq])).to(positions.device)
    posf = positions.float()
    ang = torch.cat(
        [posf[..., 0:1] * inv_freq, posf[..., 1:2] * inv_freq], dim=-1
    )
    return torch.cos(ang), torch.sin(ang)


def rotate_half_axial(x: torch.Tensor) -> torch.Tensor:
    """rotate_half applied independently within the y-half and the x-half."""
    half = x.shape[-1] // 2
    return torch.cat([rotate_half(x[..., :half]), rotate_half(x[..., half:])], dim=-1)


def apply_rope2d_bshd(
    tokens: torch.Tensor,  # (B, S, H, D)
    cos: torch.Tensor,  # (B, S, D)
    sin: torch.Tensor,
) -> torch.Tensor:
    t = tokens.float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return (t * c + rotate_half_axial(t) * s).to(tokens.dtype)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """mRoPE of q (S, H, D) and k (S, KVH, D) with cos/sin (S, D) in fp32;
    returns the inputs' dtypes. A decode step passes S = 1."""
    c, s = cos[:, None, :], sin[:, None, :]
    qf, kf = q.float(), k.float()
    return (qf * c + rotate_half(qf) * s).to(q.dtype), (kf * c + rotate_half(kf) * s).to(k.dtype)


def vision_rope_cos_sin(
    pos_hw: torch.Tensor,  # (S, 2) int: (h, w) patch coords in merge-permuted order
    head_dim: int,
    theta: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape (S, head_dim), float32: head_dim // 2 channels per
    axis, the (h, w) frequency vectors concatenated and then duplicated."""
    dim = head_dim // 2
    inv_freq = torch.from_numpy(1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))).to(pos_hw.device)
    posf = pos_hw.float()
    half = torch.cat([posf[:, 0:1] * inv_freq[None, :], posf[:, 1:2] * inv_freq[None, :]], dim=-1)
    ang = torch.cat([half, half], dim=-1)
    return torch.cos(ang), torch.sin(ang)


# the vision rotation is the same rotate_half form on (S, heads, head_dim)
apply_vision_rope = apply_mrope
