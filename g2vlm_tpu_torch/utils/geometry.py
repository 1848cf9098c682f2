"""Geometry primitives (port of g2vlm_tpu/utils/geometry.py: what the recon
path and the training loss use)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms via R^T, -R^T t."""
    rt = mat[..., :3, :3].transpose(-1, -2)
    new_t = -rt @ mat[..., :3, 3:]
    top = torch.cat([rt, new_t], dim=-1)
    bottom = mat.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*mat.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def depth_edge(depth: torch.Tensor, rtol: float = 0.03, kernel_size: int = 3) -> torch.Tensor:
    """Mark pixels whose local relative depth range exceeds rtol:
    (maxpool(depth) + maxpool(-depth)) / depth > rtol, with -inf padding.
    depth (..., H, W) -> bool (..., H, W). The ratio (not diff > rtol * depth)
    is kept on purpose: it flips the predicate for negative depths, as in the
    JAX package."""
    pad = kernel_size // 2
    x = depth.reshape(-1, 1, *depth.shape[-2:])
    mx = F.max_pool2d(x, kernel_size, stride=1, padding=pad)  # pads with -inf
    mn = -F.max_pool2d(-x, kernel_size, stride=1, padding=pad)
    ratio = torch.nan_to_num((mx - mn) / x)  # nan -> 0, +-inf -> dtype max/min
    return (ratio > rtol).reshape(depth.shape)
