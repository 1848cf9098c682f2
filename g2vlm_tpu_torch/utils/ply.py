"""Point-cloud export (port of g2vlm_tpu/utils/ply.py): a plain binary PLY
writer, and the recon outputs as a colored point cloud (the point map
upsampled bilinearly, antialiased, to the image resolution; NaN / Inf
points dropped)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """points (N, 3) float; colors (N, 3) in [0,1] or uint8."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def save_ply_visualization(pred: dict, save_path: str, filter_nan: bool = True) -> dict:
    """pred: dict with numpy 'points' (N_views, Hp, Wp, 3) and 'images'
    (N_views, 3, H, W) in [0,1]. Upsamples the point map bilinearly
    (antialiased) to the image resolution on the host, filters NaN/Inf,
    writes a colored PLY. Returns stats: total, invalid, written, bbox."""
    from .image import resize_hw

    points = np.asarray(pred["points"], np.float32)
    images = np.asarray(pred["images"])
    h, w = images.shape[-2:]
    if points.shape[1:3] != (h, w):
        pts = resize_hw(torch.from_numpy(points.transpose(0, 3, 1, 2)), (h, w)).numpy().transpose(0, 2, 3, 1)
    else:
        pts = points
    pts = pts.reshape(-1, 3)
    colors = images.transpose(0, 2, 3, 1).reshape(-1, 3)
    stats = {"total": len(pts)}
    if filter_nan:
        valid = np.isfinite(pts).all(axis=1)
        stats["invalid"] = int((~valid).sum())
        pts, colors = pts[valid], colors[valid]
    stats["written"] = len(pts)
    if len(pts):
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        stats["bbox"] = (lo.tolist(), hi.tolist())
    write_ply(save_path, pts, colors)
    return stats
