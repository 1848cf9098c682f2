"""Joint reconstruction + understanding dataset (SPAR-style parquet rows).

The port's own copy of g2vlm_tpu/data/recon_then_und_dataset.py, which it
does not import; tests/test_torch_recon_then_und.py holds the samples of the
two equal, array for array. It reuses the port's cropping, depth_to_world_points
and the g++-built ViT preprocess (no numpy fallback). One difference: its
DINOv2 views take the shape the packer draws for the pack
(`set_random_aspect_ratio`, the recon group's rule), where the JAX package's
stay img_size square; the packer stacks the views of a pack into one array,
and configs/joint_train.yaml packs both groups' views together (the JAX
packer raises there unless the draw comes out square). Undrawn, and with
img_size a multiple of the patch size, the shape is the JAX package's.

Behavioral spec: reference data/interleave_datasets/recon_then_und_dataset.py
:25-543 — parquet rows with spatial-QA {question, answer, image_list,
depth_list, poses, intrinsic(s), task markers}; per-scene depth decode
conventions (matterport3d /4000 + 98th-pct clip, scannet|3rscan|scannetpp|
structured3d /1000, structured3d pose translation /1000); drawn visual
markers; sequence = system prompt + "Reconstruct the 3D scene." + N dino
views + N vit views + question + answer(loss).
(NB: the reference's sibling files import nonexistent modules —
interleave_datasets/__init__.py:1 and recon_then_und_dataset.py:7 are dead
upstream; this is the working equivalent.)"""

from __future__ import annotations

import io
from typing import Dict, List, Optional

import numpy as np

from .cropping import crop_resize_with_intrinsics, nearest_resize
from .draw_marker import apply_markers
from .parquet_dataset import ParquetIterable
from .recon_dataset import JsonlReconDataset, depth_to_world_points
from .vit_preprocess import preprocess_vit_image_fast

CHAT_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
RECON_PROMPT = "Reconstruct the 3D scene."
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant"
Z_FAR = 80.0  # reference :258-266 (all scenes resolve to 80)


def decode_depth(raw, scene_name: str) -> np.ndarray:
    """Per-scene depth conventions (reference _add_image, :183-241)."""
    from PIL import Image

    if isinstance(raw, (bytes, bytearray)):
        img = Image.open(io.BytesIO(raw))
    elif isinstance(raw, str):
        img = Image.open(raw)
    else:
        img = raw
    d = np.asarray(img).astype(np.int32)
    if scene_name == "matterport3d":
        depth = d / 4000.0
        depth[~np.isfinite(depth)] = 0
        pos = depth[depth > 0]
        thr = np.percentile(pos, 98) if pos.size else 0
        depth[depth > thr] = 0.0
    else:  # scannet / 3rscan / scannetpp / structured3d
        depth = d / 1000.0
        depth[~np.isfinite(depth)] = 0
    return depth.astype(np.float32)


def decode_pose(pose, scene_name: str) -> np.ndarray:
    extr = np.asarray(pose, np.float64).reshape(4, 4)
    if scene_name == "structured3d":
        extr = extr.copy()
        extr[:3, 3] = extr[:3, 3] / 1000.0  # reference :236-238
    return extr.astype(np.float32)


def _load_image(raw):
    from PIL import Image

    if isinstance(raw, (bytes, bytearray)):
        return Image.open(io.BytesIO(raw)).convert("RGB")
    if isinstance(raw, str):
        return Image.open(raw).convert("RGB")
    return raw


class ReconThenUndDataset(ParquetIterable):
    def __init__(
        self,
        dataset_name: str,
        parquet_files: List[str],
        tokenizer=None,
        img_size: int = 518,
        patch_size: int = 14,
        frame_num: int = 8,
        vit_target_hw=(768, 768),
        **dist_kwargs,
    ):
        super().__init__(dataset_name, parquet_files, **dist_kwargs)
        self.tokenizer = tokenizer
        self.img_size = img_size
        self.patch_size = patch_size
        self.frame_num = frame_num
        self.vit_target_hw = vit_target_hw
        self.random_aspect_ratio: float = 1.0
        self._rng = np.random.default_rng(0)

    def set_step_rng(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def set_random_aspect_ratio(self, ar: float):
        self.random_aspect_ratio = ar

    # (H, W) of the pack's views: the recon group's rule, so that one pack's views share a shape
    get_target_shape = JsonlReconDataset.get_target_shape

    def _encode(self, text: str) -> List[int]:
        if self.tokenizer is not None:
            return self.tokenizer.encode(text)
        return [(hash(w) % 5000) + 100 for w in text.split()]

    def parse_row(self, row: Dict) -> Optional[Dict]:
        question = row["question"]
        answer = row["answer"]
        scene_name = row.get("scene_name", "scannet")
        images = [_load_image(x) for x in row["image_list"]]
        depths = list(row["depth_list"])
        poses = list(row["poses"])
        intr_key = (
            "depth_intrinsic"
            if scene_name in ("scannet", "structured3d")
            else "intrinsic"
        )
        intr = np.asarray(row.get(intr_key, row.get("intrinsic")), np.float32)[
            :3, :3
        ]

        # drawn visual markers (reference :360-543 metadata handling)
        task_type = row.get("task_type")
        if task_type and row.get("metadata"):
            meta = row["metadata"]
            if isinstance(meta, dict):
                apply_markers(images, meta, task_type)

        h_t, w_t = (int(x) for x in self.get_target_shape(self.random_aspect_ratio))
        res = (w_t, h_t)
        dino_views, vit_views = [], []
        num_tokens = 0
        for i, (img, draw, pose) in enumerate(zip(images, depths, poses)):
            depth = decode_depth(draw, scene_name)
            extr = decode_pose(pose, scene_name)
            assert np.isfinite(extr).all()
            img_arr = np.asarray(img)
            if depth.shape[:2] != img_arr.shape[:2]:
                if scene_name == "scannet":
                    # image follows depth resolution (reference :204-206)
                    from PIL import Image as PILImage

                    img = img.resize(
                        (depth.shape[1], depth.shape[0]), PILImage.BILINEAR
                    )
                else:
                    depth = nearest_resize(depth, (img_arr.shape[1], img_arr.shape[0]))
            c_img, c_depth, c_intr = crop_resize_with_intrinsics(
                img, depth, intr.copy(), res, rng=self._rng,
                info=f"{self.dataset_name}/{scene_name}/{i}",
            )
            c_depth = np.where(c_depth > Z_FAR, 0.0, c_depth)
            pts, valid = depth_to_world_points(c_depth, c_intr, extr)
            valid &= np.isfinite(pts).all(axis=-1)
            if valid.sum() == 0:
                return None
            dino_views.append(
                dict(
                    image=np.asarray(c_img, np.uint8),
                    depths=np.where(valid, c_depth, 0.0).astype(np.float32),
                    extrinsics=extr,
                    intrinsics=c_intr,
                    world_points=np.where(valid[..., None], pts, 0.0).astype(
                        np.float32
                    ),
                    point_masks=valid,
                    view_infos=f"{scene_name}/{self.dataset_name}/{i}",
                    image_paths="",
                )
            )
            patches, grid = preprocess_vit_image_fast(c_img, target_hw=self.vit_target_hw)
            vit_views.append({"patches": patches, "grid_thw": grid})
            hw = (res[1] // self.patch_size) * (res[0] // self.patch_size)
            num_tokens += hw + 2 + int(np.prod(grid)) // 4 + 2

        # sequence plan (reference apply_template_qwenvl2_reconThenUnd,
        # data_utils.py:328-383: system -> recon text -> dino -> vit ->
        # question -> answer with loss)
        text_segments = [
            (CHAT_SYSTEM, 0),
            (RECON_PROMPT, 0),
        ]
        plan = [
            {"type": "text", "enable_cfg": 0, "loss": 0, "special_token_loss": 0},
            {"type": "text", "enable_cfg": 0, "loss": 0, "special_token_loss": 0},
        ]
        plan += [
            {"type": "dino_image", "enable_cfg": 0, "loss": 0,
             "special_token_loss": 0}
            for _ in dino_views
        ]
        plan += [
            {"type": "vit_image", "enable_cfg": 0, "loss": 0,
             "special_token_loss": 0}
            for _ in vit_views
        ]
        text_segments += [(question + CHAT_SUFFIX, 0), ("\n" + answer, 1)]
        plan += [
            {"type": "text", "enable_cfg": 0, "loss": 0, "special_token_loss": 0},
            {"type": "text", "enable_cfg": 0, "loss": 1, "special_token_loss": 0},
        ]
        text_ids_list = [self._encode(t) for t, _ in text_segments]
        num_tokens += sum(len(t) for t in text_ids_list) + 1  # +1 answer eos

        return dict(
            plan=plan,
            text_ids_list=text_ids_list,
            dino_views=dino_views,
            vit_views=vit_views,
            num_tokens=num_tokens,
        )
