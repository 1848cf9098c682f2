"""Geometry primitives (port of g2vlm_tpu/utils/geometry.py): rigid
transforms, depth unprojection, normals and the depth-edge mask, on tensors."""

from __future__ import annotations

from typing import Optional

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


def transform_points(mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., H, W, 3) points -> (..., H, W, 3)."""
    out = torch.einsum("...ij,...hwj->...hwi", mat, homogenize_points(points))
    return out[..., :3]


def depthmap_to_camera_coordinates(depth: torch.Tensor, intrinsics: torch.Tensor):
    """Unproject an (H, W) depth map to camera-frame points with a pinhole
    model: (points (H, W, 3), valid (H, W) where depth > 0)."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1), depth > 0.0


def depthmap_to_world_coordinates(depth: torch.Tensor, intrinsics: torch.Tensor, cam2world: torch.Tensor):
    """(H, W) depth, (3, 3) intrinsics, (4, 4) cam2world -> (world points
    (H, W, 3), valid (H, W))."""
    pts_cam, valid = depthmap_to_camera_coordinates(depth, intrinsics)
    return transform_points(cam2world, pts_cam), valid


def points_to_normals(points: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Per-pixel normals of a point map (..., H, W, 3) from cross products of
    forward differences -> ((..., H-1, W-1, 3), the mask of pixels whose 2x2
    neighbourhood is valid or None)."""
    dx = points[..., :, 1:, :] - points[..., :, :-1, :]
    dy = points[..., 1:, :, :] - points[..., :-1, :, :]
    n = torch.linalg.cross(dx[..., :-1, :, :], dy[..., :, :-1, :], dim=-1)
    n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if mask is None:
        return n, None
    return n, mask[..., 1:, 1:] & mask[..., :-1, :-1] & mask[..., 1:, :-1] & mask[..., :-1, 1:]
