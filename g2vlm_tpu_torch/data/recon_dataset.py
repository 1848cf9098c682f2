"""Multi-view 3D reconstruction dataset over JSONL annotations (the port's own
copy of g2vlm_tpu/data/recon_dataset.py, numpy, which it does not import;
tests/test_torch_data_path.py and tests/test_torch_eval_tools.py hold the two
equal): per-scene rows listing frames with RGB, depth, pose and intrinsics;
frame sampling (a random window, stratified, or ranked by pose), DUSt3R-style
crop / resize with the intrinsics updated, depth to world points and validity
masks, and a sequence plan of [text "Reconstruct the 3D scene.", N x
dino_image] for the packer. `load_depth` and `depth_to_world_points` are what
the evaluation tools read.

Annotation row (JSON per line):
  {"scene_name": ..., "seq_name": ...,
   "frames": [{"image": path, "depth": path|null,
               "extrinsics": 4x4 cam2world list, "intrinsics": 3x3 list,
               "depth_scale": float (divide raw depth by this)}, ...]}
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np

from .cropping import crop_resize_with_intrinsics
from .distributed import DistributedIterable
from .frame_sampling import compute_ranking

RECON_PROMPT = "Reconstruct the 3D scene."


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


class JsonlReconDataset(DistributedIterable):
    """Iterable over packed-sample dicts consumed by
    data/packing.SequencePacker."""

    def __init__(
        self,
        dataset_name: str,
        jsonl_paths: List[str],
        tokenizer=None,
        img_size: int = 518,
        patch_size: int = 14,
        frame_num: int = 8,
        sampling: str = "nearby",  # nearby | stratified | pose_rank
        aug_crop: int = 0,
        aug_focal: float = 0.0,
        shuffle_views: bool = True,
        allow_retry_times: int = 50,
        prompt_ids: Optional[List[int]] = None,
        invalid_list_path: Optional[str] = None,
        **dist_kwargs,
    ):
        super().__init__(dataset_name, **dist_kwargs)
        # frame blacklist (reference scannet_recon_invalid_list.json,
        # recon_dataset.py:167-169): json list of image paths/view infos
        self.invalid_frames = set()
        if invalid_list_path:
            import json as _json

            with open(invalid_list_path) as f:
                self.invalid_frames = set(_json.load(f))
        self.jsonl_paths = list(jsonl_paths)
        self.tokenizer = tokenizer
        self.img_size = img_size
        self.patch_size = patch_size
        self.frame_num = frame_num
        self.sampling = sampling
        self.aug_crop = aug_crop
        self.aug_focal = aug_focal
        self.shuffle_views = shuffle_views
        self.allow_retry_times = allow_retry_times
        self.prompt_ids = prompt_ids
        self.random_image_num: Optional[int] = None
        self.random_aspect_ratio: float = 1.0
        self._rng = np.random.default_rng(0)
        # rows are the shardable unit
        rows = []
        for p in self.jsonl_paths:
            with open(p) as f:
                rows.extend([(line, p) for line in f if line.strip()])
        self.data_paths = rows
        self.set_epoch()

    # knobs the packer sets per step (reference dataset_base.py:337-344)
    def set_random_image_num(self, n: int):
        self.random_image_num = n

    def set_random_aspect_ratio(self, ar: float):
        self.random_aspect_ratio = ar

    def set_step_rng(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def get_target_shape(self, aspect_ratio: float) -> np.ndarray:
        """(H, W) with H = img_size*ar floored to patch multiples (reference
        get_target_shape, recon_dataset.py:469-487)."""
        short = int(self.img_size * aspect_ratio)
        if short % self.patch_size != 0:
            short = (short // self.patch_size) * self.patch_size
        return np.array([short, self.img_size])

    def _sample_frame_ids(self, n_total: int, n_views: int, extrinsics=None):
        rng = self._rng
        if n_total <= n_views:
            return list(np.sort(rng.choice(n_total, n_views, replace=True)))
        mode = self.sampling
        if mode == "pose_rank" and extrinsics is not None:
            anchor = int(rng.integers(n_total))
            ranking, _ = compute_ranking(np.asarray(extrinsics))
            return list(ranking[anchor][:n_views])
        if mode == "stratified":
            bins = np.linspace(0, n_total, n_views + 1).astype(int)
            return [
                int(rng.integers(lo, max(hi, lo + 1)))
                for lo, hi in zip(bins[:-1], bins[1:])
            ]
        # nearby window (reference get_nearby_ids, recon_dataset.py:307-375)
        window = min(n_total, max(n_views * 4, n_views + 1))
        start = int(rng.integers(0, n_total - window + 1))
        ids = rng.choice(np.arange(start, start + window), n_views - 1, replace=True)
        return [start] + list(np.sort(ids))

    def _encode_prompt(self) -> List[int]:
        if self.prompt_ids is not None:
            return list(self.prompt_ids)
        if self.tokenizer is not None:
            return self.tokenizer.encode(RECON_PROMPT)
        return [(hash(w) % 5000) + 100 for w in RECON_PROMPT.split()]

    def __iter__(self) -> Iterator[Dict]:
        from PIL import Image

        rows, worker_id = self.get_data_paths_per_worker()
        cursor = self.status_for_worker(worker_id)
        row_start = (cursor + 1) if cursor is not None else 0
        retry = 0
        while True:
            for row_idx, (line, src) in enumerate(
                rows[row_start:], start=row_start
            ):
                try:
                    item = json.loads(line)
                    frames = item["frames"]
                    n_views = self.random_image_num or self.frame_num
                    target_hw = self.get_target_shape(self.random_aspect_ratio)
                    h_t, w_t = int(target_hw[0]), int(target_hw[1])
                    if self.invalid_frames:
                        frames = [
                            f for f in frames
                            if f["image"] not in self.invalid_frames
                        ]
                    extr_all = [np.asarray(f["extrinsics"], np.float32) for f in frames]
                    ids = self._sample_frame_ids(len(frames), n_views, extr_all)
                    if self.shuffle_views:
                        self._rng.shuffle(ids)

                    views = []
                    for fi in ids:
                        f = frames[fi]
                        img = Image.open(f["image"]).convert("RGB")
                        depth = (
                            load_depth(f["depth"], f.get("depth_scale", 1000.0))
                            if f.get("depth")
                            else None
                        )
                        intr = np.asarray(f["intrinsics"], np.float32)
                        c2w = np.asarray(f["extrinsics"], np.float32)
                        assert np.isfinite(c2w).all() and np.isfinite(intr).all()
                        img, depth, intr = crop_resize_with_intrinsics(
                            img, depth, intr, (w_t, h_t),
                            aug_crop=self.aug_crop, aug_focal=self.aug_focal,
                            rng=self._rng,
                            info=f"{self.dataset_name}/{item.get('seq_name')}",
                        )
                        if depth is None:
                            depth = np.zeros((h_t, w_t), np.float32)
                        pts_w, valid = depth_to_world_points(depth, intr, c2w)
                        assert valid.sum() > 0, "no valid depth"
                        views.append(
                            dict(
                                image=np.asarray(img, np.uint8),
                                depths=depth,
                                extrinsics=c2w,
                                intrinsics=intr,
                                world_points=pts_w,
                                point_masks=valid,
                                view_infos=f"{item.get('scene_name', self.dataset_name)}/"
                                f"{item.get('seq_name', '')}/{fi}",
                                image_paths=f["image"],
                            )
                        )
                except Exception as e:  # retry-and-skip (reference :629-820)
                    retry += 1
                    if retry >= self.allow_retry_times:
                        raise
                    continue

                retry = 0
                text_ids = self._encode_prompt()
                hw_tokens = (h_t // self.patch_size) * (w_t // self.patch_size)
                num_tokens = len(text_ids) + len(views) * (hw_tokens + 2)
                plan = [
                    {"type": "text", "enable_cfg": 0, "loss": 0,
                     "special_token_loss": 0}
                ] + [
                    {"type": "dino_image", "enable_cfg": 0, "loss": 0,
                     "special_token_loss": 0}
                    for _ in views
                ]
                yield dict(
                    plan=plan,
                    text_ids_list=[text_ids],
                    dino_views=views,
                    num_tokens=num_tokens,
                    data_indexes={
                        "data_indexes": row_idx,
                        "worker_id": worker_id,
                        "dataset_name": self.dataset_name,
                    },
                )
            row_start = 0
