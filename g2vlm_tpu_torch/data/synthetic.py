"""Synthetic annotated-scene generation for harness smoke runs: the port's own
copy of g2vlm_tpu/data/synthetic.py (numpy + PIL), which it does not import.

Produces the JsonlReconDataset row format (data/recon_dataset.py) —
RGB PNGs + 16-bit depth PNGs + GT extrinsics/intrinsics — so
eval_camera_torch.py / eval_points_torch.py run end-to-end with no datasets on disk
(`--tiny`). The reference has no equivalent (its eval metrics are never
wired to a harness; modeling/g2vlm/metric.py)."""

from __future__ import annotations

import json
import os

import numpy as np


def make_tiny_scene_jsonl(
    dir_path: str,
    n_frames: int = 4,
    hw=(84, 140),
    seed: int = 0,
) -> str:
    """Write one synthetic scene into `dir_path`; returns the jsonl path.

    Depth is a smooth positive field (2-3 m) stored as uint16 mm PNG; the
    cameras trace a small arc (rotation about y + translation) so relative
    pose errors and AUC are well-defined."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    frames = []
    for i in range(n_frames):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ip = os.path.join(dir_path, f"rgb_{i}.png")
        Image.fromarray(img).save(ip)

        depth_m = (
            2.0
            + 0.5 * np.sin(np.linspace(0.0, 3.0, h))[:, None]
            + 0.3 * np.cos(np.linspace(0.0, 2.0, w))[None, :]
            + 0.1 * i
        )
        dp = os.path.join(dir_path, f"depth_{i}.png")
        Image.fromarray((depth_m * 1000.0).astype(np.uint16)).save(dp)

        a = 0.05 * i
        c2w = np.eye(4)
        c2w[:3, :3] = np.array(
            [
                [np.cos(a), 0.0, np.sin(a)],
                [0.0, 1.0, 0.0],
                [-np.sin(a), 0.0, np.cos(a)],
            ]
        )
        c2w[:3, 3] = [0.1 * i, 0.02 * i, 0.05 * i]
        intr = [[100.0, 0.0, w / 2], [0.0, 100.0, h / 2], [0.0, 0.0, 1.0]]
        frames.append(
            {
                "image": ip,
                "depth": dp,
                "depth_scale": 1000.0,
                "extrinsics": c2w.tolist(),
                "intrinsics": intr,
            }
        )
    path = os.path.join(dir_path, "scenes.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"frames": frames}) + "\n")
    return path
