"""Depth annotations of the JSONL recon scenes (port of the host helpers of
g2vlm_tpu/data/recon_dataset.py, numpy, which the port does not import):
`load_depth` and `depth_to_world_points`, what the evaluation tools read.
The dataset class `JsonlReconDataset` waits for ROADMAP A.8 (the data path).

Annotation row (JSON per line):
  {"scene_name": ..., "seq_name": ...,
   "frames": [{"image": path, "depth": path|null,
               "extrinsics": 4x4 cam2world list, "intrinsics": 3x3 list,
               "depth_scale": float (divide raw depth by this)}, ...]}
"""

from __future__ import annotations

import numpy as np


def depth_to_world_points(depth, intrinsics, cam2world):
    """(H, W) depth -> world points (H, W, 3) + valid mask (numpy; the tensor
    equivalent is utils/geometry.py depthmap_to_world_coordinates)."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u = np.arange(w)[None, :]
    v = np.arange(h)[:, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    pts_cam = np.stack([x, y, depth], axis=-1)
    r = cam2world[:3, :3]
    t = cam2world[:3, 3]
    pts_w = pts_cam @ r.T + t
    valid = np.isfinite(depth) & (depth > 0)
    return pts_w.astype(np.float32), valid


def load_depth(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """16-bit PNG (mm) or .npy/.npz depth loader."""
    if path.endswith((".npy",)):
        d = np.load(path)
    elif path.endswith(".npz"):
        z = np.load(path)
        d = z[list(z.keys())[0]]
    else:
        from PIL import Image

        d = np.asarray(Image.open(path))
    return d.astype(np.float32) / depth_scale
