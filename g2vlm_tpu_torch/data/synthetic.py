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


# the metadata of every synthetic SPAR row: every key any task type of draw_marker.TASK_MARKERS reads, in
# 0-1000 normalised coordinates (parquet stores one struct type for the column, so every row carries them all)
_SPAR_METADATA = {
    "red_point": [[500, 500]], "blue_point": [[150, 250]], "green_point": [[800, 300]],
    "red_bbox": [[100, 100, 400, 400]], "blue_bbox": [[500, 500, 900, 900]],
    "green_bbox": [[50, 600, 300, 950]], "yellow_bbox": [[600, 50, 950, 300]],
    "point_img_idx": [[0, 1, 0]], "bbox_img_idx": [[0, 1, 0, 1]],
    "point_list": [[[500, 500], [200, 200]]],
}
SPAR_SCENES = ("scannet", "structured3d")


def spar_row(rng, scene_name: str, task_type: str, n_views: int = 2, hw=(96, 128), depth_hw=(48, 64),
             question: str = "How far apart are the red and blue points?", answer: str = "About two meters.") -> dict:
    """One SPAR-style row of the recon_then_und group (data/recon_then_und_dataset.py): PNG bytes of
    `n_views` random images of `hw`, 16-bit depth PNGs of `depth_hw` in the scene's convention
    (millimetres; matterport3d quarter millimetres), camera-to-world poses on a small arc (structured3d's
    translation in millimetres), intrinsics of the depth maps' and the images' resolution, a question, an
    answer, and a task type whose markers the metadata lets every view draw."""
    import io

    from PIL import Image

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    h, w = hw
    dh, dw = depth_hw
    scale = 4000.0 if scene_name == "matterport3d" else 1000.0
    images, depths, poses = [], [], []
    for i in range(n_views):
        images.append(png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        depth_m = (1.5 + 0.5 * np.sin(np.linspace(0.0, 3.0, dh))[:, None]
                   + 0.3 * np.cos(np.linspace(0.0, 2.0, dw))[None, :] + 0.2 * rng.random((dh, dw)) + 0.1 * i)
        depths.append(png((depth_m * scale).astype(np.uint16)))
        a = 0.05 * i
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]]
        pose[:3, 3] = np.array([0.1 * i, 0.02 * i, 0.05 * i]) * (1000.0 if scene_name == "structured3d" else 1.0)
        poses.append(pose.reshape(-1).tolist())

    def intrinsic(rh, rw):
        return [[0.9 * rw, 0.0, rw / 2, 0.0], [0.0, 0.9 * rw, rh / 2, 0.0], [0.0, 0.0, 1.0, 0.0], [0, 0, 0, 1.0]]

    return dict(question=question, answer=answer, scene_name=scene_name, image_list=images, depth_list=depths,
                poses=poses, intrinsic=intrinsic(h, w), depth_intrinsic=intrinsic(dh, dw), task_type=task_type,
                metadata=dict(_SPAR_METADATA))


def write_spar_parquet(path: str, rows, row_group_size: int = 2) -> str:
    """Rows as `spar_row` makes them -> one parquet file at `path` (needs pyarrow)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.Table.from_pylist(list(rows)), path, row_group_size=row_group_size)
    return path


def make_joint_train_data(
    dir_path: str,
    target_size: int = 518,
    vit_hw=(768, 768),
    n_scenes: int = 2,
    n_frames: int = 4,
    scene_hw=(84, 140),
    n_spar_rows: int = 4,
    spar_hw=(96, 128),
    spar_depth_hw=(48, 64),
    n_chats: int = 3,
    image_hw=(64, 80),
    n_video_frames: int = 8,
    video_hw=(64, 80),
    frames_per_video: int = 8,
    question_words: int = 6,
    answer_words: int = 6,
    seed: int = 0,
) -> dict:
    """The data config of configs/joint_train.yaml's three groups, in its order and with its weights,
    mandatory flags and transform arguments, over data written into `dir_path` from `seed`: the scenes
    of `make_tiny_joint_data` (`recon`); `n_spar_rows` SPAR-style rows (`spar_row`) in one parquet
    file, their scenes alternating over SPAR_SCENES and their task types over
    draw_marker.TASK_MARKERS (`recon_then_und`); `n_chats` LLaVA-style rows of one random PNG of
    `image_hw` each, then a video row: a folder of `n_video_frames` PNG frames of `video_hw`, of which
    the row's `frames_per_video` `<image>` tags take the first (`vlm_sft`). Every question has
    `question_words` words and every answer `answer_words` (a word is a token without a tokenizer).
    `target_size` is the DINOv2 views' width, `vit_hw` the ViT images' first resize in `vlm_sft` (the
    recon_then_und group takes 768x768 whatever the config says, as in the JAX package)."""
    from PIL import Image

    from .draw_marker import TASK_MARKERS

    cfg = make_tiny_joint_data(dir_path, n_scenes=n_scenes, n_frames=n_frames, scene_hw=scene_hw, n_chats=0,
                               target_size=target_size, vit_hw=vit_hw, seed=seed)
    rng = np.random.default_rng(seed + 2000)

    def words(n, stem):
        return " ".join(f"{stem}{i % 97}" for i in range(n))

    question, answer = words(question_words, "where"), words(answer_words, "there")
    tasks = sorted(TASK_MARKERS)
    spar_dir = os.path.join(dir_path, "spar")
    os.makedirs(spar_dir, exist_ok=True)
    rows = [spar_row(rng, SPAR_SCENES[i % len(SPAR_SCENES)], tasks[(7 * i) % len(tasks)], hw=spar_hw,
                     depth_hw=spar_depth_hw, question=question, answer=answer) for i in range(n_spar_rows)]
    write_spar_parquet(os.path.join(spar_dir, "rows.parquet"), rows)

    frames = os.path.join(dir_path, "video_frames")
    os.makedirs(frames, exist_ok=True)
    for i in range(n_video_frames):
        Image.fromarray(rng.integers(0, 256, (*video_hw, 3), dtype=np.uint8)).save(
            os.path.join(frames, f"frame_{i:04d}.png"))
    with open(cfg["vlm_sft"]["dataset_info"]["tiny_chats"]["jsonl_path"], "w") as f:
        for i in range(n_chats):
            name = f"chat_{i}.png"
            Image.fromarray(rng.integers(0, 256, (*image_hw, 3), dtype=np.uint8)).save(os.path.join(dir_path, name))
            conv = [{"from": "human", "value": f"<image>\n{question} {i}?"}, {"from": "gpt", "value": answer}]
            f.write(json.dumps({"image": name, "conversations": conv}) + "\n")
        conv = [{"from": "human", "value": "<image>" * frames_per_video + f"\n{question}?"},
                {"from": "gpt", "value": answer}]
        f.write(json.dumps({"video": "video_frames", "conversations": conv}) + "\n")

    recon, vlm = cfg["recon"], cfg["vlm_sft"]
    vlm["frame_sampler_args"] = {"max_num_frames": 12, "min_num_frames": 8}
    return {
        "recon": recon,
        "recon_then_und": {
            "dataset_names": ["tiny_spar"],
            "dino_image_transform_args": {"target_size": target_size},
            "vit_image_transform_args": {"image_size_h": 768, "image_size_w": 768},
            "is_mandatory": True,
            "weight": 1.0,
            "dataset_info": {"tiny_spar": {"data_dir": spar_dir, "num_used_data": 1}},
        },
        "vlm_sft": vlm,
    }
