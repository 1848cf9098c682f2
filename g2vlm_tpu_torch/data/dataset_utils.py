"""VGGT-style dataset processing utilities.

The port's own copy of g2vlm_tpu/data/dataset_utils.py, which it does not import;
tests/test_torch_data_helpers.py holds the two equal.

Behavioral spec: reference data/dataset_utils_vggt.py:45-657 — joint
depth/pose/intrinsics transforms used by the dataset builders: depth scaling,
principal-point crops, resizes, 90-degree rotations with intrinsics/extrinsics
fixups, depth->coords, and PLY export (the writer lives in utils/ply.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .cropping import nearest_resize
from .recon_dataset import depth_to_world_points


def transform_depth(depth: np.ndarray, scale: float, z_far: float = 0.0) -> np.ndarray:
    """Scale raw depth and zero out far/invalid values (reference
    transform_depth)."""
    d = depth.astype(np.float32) / scale
    d[~np.isfinite(d)] = 0.0
    if z_far > 0:
        d[d > z_far] = 0.0
    return d


def crop_image_depth_and_intrinsic_by_pp(
    image: np.ndarray, depth: Optional[np.ndarray], intrinsics: np.ndarray
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Largest principal-point-centered crop (reference
    crop_image_depth_and_intrinsic_by_pp)."""
    h, w = image.shape[:2]
    cx, cy = np.round(intrinsics[:2, 2]).astype(int)
    mx = min(cx, w - cx)
    my = min(cy, h - cy)
    l, t, r, b = cx - mx, cy - my, cx + mx, cy + my
    out_k = intrinsics.copy()
    out_k[0, 2] -= l
    out_k[1, 2] -= t
    d = depth[t:b, l:r] if depth is not None else None
    return image[t:b, l:r], d, out_k


def resize_image_depth_and_intrinsic(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    intrinsics: np.ndarray,
    target_hw: Tuple[int, int],
):
    """Joint resize: bilinear image, nearest depth, scaled intrinsics."""
    from PIL import Image

    th, tw = target_hw
    h, w = image.shape[:2]
    img = np.asarray(
        Image.fromarray(image).resize((tw, th), Image.Resampling.BILINEAR)
    )
    d = nearest_resize(depth, (tw, th)) if depth is not None else None
    k = intrinsics.copy()
    k[0] *= tw / w
    k[1] *= th / h
    return img, d, k


def rotate_90_degrees(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    intrinsics: np.ndarray,
    extrinsics: np.ndarray,
    clockwise: bool = True,
):
    """Rotate view 90deg with consistent camera fixups (reference
    rotate_90_degrees). extrinsics is cam2world."""
    h, w = image.shape[:2]
    k = np.asarray(intrinsics, np.float64)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    rot = np.eye(4)
    if clockwise:
        img = np.rot90(image, k=-1).copy()
        d = np.rot90(depth, k=-1).copy() if depth is not None else None
        new_k = np.array(
            [[fy, 0, h - 1 - cy], [0, fx, cx], [0, 0, 1]], np.float64
        )
        ang = -np.pi / 2
    else:
        img = np.rot90(image, k=1).copy()
        d = np.rot90(depth, k=1).copy() if depth is not None else None
        new_k = np.array(
            [[fy, 0, cy], [0, fx, w - 1 - cx], [0, 0, 1]], np.float64
        )
        ang = np.pi / 2
    # rotate the camera frame about its z (optical) axis
    c, s = np.cos(ang), np.sin(ang)
    rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    new_extr = np.asarray(extrinsics, np.float64) @ rz
    return img, d, new_k.astype(np.float32), new_extr.astype(np.float32)


def depth_to_world_coords_points(depth, intrinsics, cam2world):
    """Alias matching the reference naming (dataset_utils_vggt.py)."""
    return depth_to_world_points(depth, intrinsics, cam2world)
