"""Synthetic annotated-scene generation for harness smoke runs: the port's own
copy of g2vlm_tpu/data/synthetic.py (numpy + PIL), which it does not import,
and (port only) `make_tiny_joint_data`, a data config of such scenes and of
image conversations for train_torch.py --data_config.

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


def make_tiny_joint_data(
    dir_path: str,
    n_scenes: int = 2,
    n_frames: int = 4,
    scene_hw=(84, 140),
    n_chats: int = 3,
    image_hw=(64, 80),
    target_size: int = 518,
    vit_hw=(768, 768),
    seed: int = 0,
) -> dict:
    """Write `n_scenes` synthetic scenes (one JSONL row each, as
    `make_tiny_scene_jsonl` makes them) and `n_chats` LLaVA-style rows of one
    random PNG and a question and answer each into `dir_path`; returns the
    data config (the layout of configs/joint_train.yaml) of a mandatory
    `recon` group and a `vlm_sft` group over them. `target_size` is the DINOv2
    views' width, `vit_hw` the ViT images' first resize."""
    from PIL import Image

    rows = []
    for i in range(n_scenes):
        sub = os.path.join(dir_path, f"scene_{i}")
        os.makedirs(sub, exist_ok=True)
        with open(make_tiny_scene_jsonl(sub, n_frames, scene_hw, seed + i)) as f:
            rows.append(f.read().strip())
    recon = os.path.join(dir_path, "recon.jsonl")
    with open(recon, "w") as f:
        f.write("\n".join(rows) + "\n")
    rng = np.random.default_rng(seed + 1000)
    chat = os.path.join(dir_path, "vlm.jsonl")
    with open(chat, "w") as f:
        for i in range(n_chats):
            name = f"chat_{i}.png"
            Image.fromarray(rng.integers(0, 256, (*image_hw, 3), dtype=np.uint8)).save(os.path.join(dir_path, name))
            conv = [{"from": "human", "value": f"<image>\nWhat colour is patch {i}?"},
                    {"from": "gpt", "value": f"Mostly noise, number {i}."}]
            f.write(json.dumps({"image": name, "conversations": conv}) + "\n")
    return {
        "recon": {
            "dataset_names": ["tiny_scenes"],
            "dino_image_transform_args": {"target_size": target_size},
            "is_mandatory": True,
            "weight": 1.0,
            "dataset_info": {"tiny_scenes": {"jsonl_path": recon}},
        },
        "vlm_sft": {
            "dataset_names": ["tiny_chats"],
            "vit_image_transform_args": {"image_size_h": vit_hw[0], "image_size_w": vit_hw[1]},
            "weight": 1.0,
            "dataset_info": {"tiny_chats": {"jsonl_path": chat, "data_dir": dir_path}},
        },
    }
