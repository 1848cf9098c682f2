"""Token-packing dataset — the heart of training input.

The port's own copy of g2vlm_tpu/data/packing.py, which it does not import;
tests/test_torch_data_path.py holds the packs of the two equal, field by
field, on the same files and seeds. One addition: `PackedIterableDataset`
can be resumed exactly (`group_rng`, `resume_status`, `resume`); it draws
each sample's group from its own generator where the JAX package uses
Python's global one, so the two agree when both are seeded alike. A second:
where the JAX packer loops forever on samples that are all too long to fit a
pack alone, the port raises after `MAX_TOO_LONG_IN_A_ROW` of them. A third:
where the JAX packer raises in `to_batch` once a pack's ViT images hold more
patch rows than `max_vit_patches`, the port closes the pack before the sample
that would overflow them, as it does for tokens.

Behavioral spec: reference data/dataset_base.py:30-795 (PackedDataset):
weighted sampling over dataset groups with mandatory groups, per-step RNG
controlling view count [2,24] and aspect ratio [0.5,1.2], packing samples into
one flat token stream up to max_num_tokens, per-sample attention plans
(split_lens/attn_modes), CE loss spans weighted by len2weight, dino GT stacks,
co-jitter augmentation, and padding to the fixed max_num_tokens.

TPU-first differences:
  * emits numpy arrays shaped for the jitted train step (TrainBatch): fixed
    max_num_tokens sequence, fixed CE-slot count (padded, weight 0), fused
    TokenInfo metadata instead of nested masks / flex block masks;
  * all per-batch dino views share one shape (the reference already enforces
    a per-step aspect ratio), so GT stacks are dense arrays.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def len2weight(x: int, loss_reduction: str = "square") -> float:
    """CE weight per answer span (reference data/data_utils.py:316-325)."""
    if x == 0:
        return 0.0
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / x
    if loss_reduction == "square":
        return 1.0 / (x ** 0.5)
    raise NotImplementedError(loss_reduction)


@dataclass
class PackerConfig:
    expected_num_tokens: int = 32768
    max_num_tokens_per_sample: int = 16384
    max_num_tokens: int = 36864
    max_ce_slots: int = 4096
    text_cond_dropout_prob: float = 0.1
    vit_cond_dropout_prob: float = 0.4
    dino_cond_dropout_prob: float = 0.4
    dino_patch_size: int = 14
    aspect_ratio_range: Tuple[float, float] = (0.5, 1.2)
    image_num_range: Tuple[int, int] = (2, 24)
    cojitter_prob: float = 0.7  # reference dataset_base.py:88-90 (1-0.3)
    loss_reduction: str = "square"
    base_seed: int = 42
    # SPLIT expert layout (mot_decoder.SPLIT): emit [und|pad|geo] physical
    # order + a bucketed static geo_start for 1x-FLOPs mixed training
    sorted_layout: bool = False
    geo_start_bucket: int = 256
    # Fixed ViT slot count for the jitted train step: vit patch rows are
    # padded to this many (0 = no vit branch; packs containing vit images
    # then raise). vit_indexes pads with max_num_tokens (out of bounds ->
    # dropped by the trainer's mode="drop" scatter).
    max_vit_patches: int = 0
    vit_patch_dim: int = 1176  # 3 * tps(2) * 14 * 14


class SequencePacker:
    """Accumulates samples into one packed stream (reference pack_sequence,
    dataset_base.py:392-638). Token ids for specials come from new_token_ids.
    """

    def __init__(self, cfg: PackerConfig, new_token_ids: Dict[str, int]):
        self.cfg = cfg
        self.ids = new_token_ids
        self.reset()

    def reset(self):
        self.curr = 0
        self.rope = 0  # NB: rope restarts per sample (reference curr_rope_id)
        self.doc = 0
        self.split = 0
        self.text_ids: List[int] = []
        self.text_indexes: List[int] = []
        self.ce_indexes: List[int] = []
        self.ce_labels: List[int] = []
        self.ce_weights: List[float] = []
        self.dino_indexes: List[int] = []
        self.vit_indexes: List[int] = []
        self.pos_ids: List[np.ndarray] = []
        self.doc_id: List[int] = []
        self.fn_id: List[int] = []
        self.is_geo: List[bool] = []
        self.dino_images: List[np.ndarray] = []
        self.vit_patches: List[np.ndarray] = []
        self.vit_grids: List[Tuple[int, int, int]] = []
        self.gt: Dict[str, List] = {
            k: []
            for k in (
                "depths", "extrinsics", "intrinsics", "world_points",
                "point_masks", "view_infos", "image_paths",
            )
        }
        self.sample_lens: List[int] = []
        self.img_per_seq: List[int] = []
        self.data_indexes: List[Any] = []

    # -- low-level emitters -------------------------------------------------
    def _emit(self, n: int, fn: int, geo: bool, pos: np.ndarray):
        self.doc_id.extend([self.doc] * n)
        self.fn_id.extend([fn] * n)
        self.is_geo.extend([geo] * n)
        self.pos_ids.append(pos)
        self.curr += n

    def _text_token(self, tok: int, fn: int):
        self.text_ids.append(tok)
        self.text_indexes.append(self.curr)
        self._emit(1, fn, False, np.full((3, 1), self.rope, np.int64))
        self.rope += 1

    def _grid_pos(self, t: int, h: int, w: int) -> np.ndarray:
        ti = np.repeat(np.arange(t, dtype=np.int64), h * w)
        hi = np.tile(np.repeat(np.arange(h, dtype=np.int64), w), t)
        wi = np.tile(np.arange(w, dtype=np.int64), t * h)
        return np.stack([ti, hi, wi]) + self.rope

    @property
    def vit_rows(self) -> int:
        """ViT patch rows packed so far."""
        return sum(p.shape[0] for p in self.vit_patches)

    def vit_rows_added(self, sample: Dict, rng: random.Random) -> int:
        """The ViT patch rows that add_sample(sample, rng) would pack: its
        conditioning-dropout draws replayed on a copy of rng's state."""
        replay = random.Random()
        replay.setstate(rng.getstate())
        vit_iter = iter(sample.get("vit_views", []))
        rows = 0
        for item in sample["plan"]:
            if item["type"] == "text" and item.get("enable_cfg"):
                replay.random()
            elif item["type"] == "vit_image":
                view = next(vit_iter)
                if item.get("enable_cfg") and replay.random() < self.cfg.vit_cond_dropout_prob:
                    continue
                rows += view["patches"].shape[0]
        return rows

    # -- packing ------------------------------------------------------------
    def add_sample(self, sample: Dict, rng: random.Random) -> None:
        plan = sample["plan"]
        text_iter = iter(sample.get("text_ids_list", []))
        dino_iter = iter(sample.get("dino_views", []))
        vit_iter = iter(sample.get("vit_views", []))
        self.rope = 0
        sample_start = self.curr
        n_imgs = 0

        for item in plan:
            kind = item["type"]
            if kind == "text":
                ids = list(next(text_iter))
                if item.get("enable_cfg") and rng.random() < self.cfg.text_cond_dropout_prob:
                    continue
                fn = -1
                start = self.curr
                for tok in ids:
                    self._text_token(int(tok), fn)
                if item.get("loss"):
                    n = len(ids)
                    self.ce_indexes.extend(range(start, start + n))
                    self.ce_weights.extend(
                        [len2weight(n, self.cfg.loss_reduction)] * n
                    )
                    self.ce_labels.extend(list(ids[1:]) + [self.ids["eos_token_id"]])
                    self._text_token(self.ids["eos_token_id"], fn)
            elif kind == "vit_image":
                view = next(vit_iter)
                if item.get("enable_cfg") and rng.random() < self.cfg.vit_cond_dropout_prob:
                    self.rope += 1
                    continue
                fn = self.split
                self.split += 1
                patches, grid = view["patches"], view["grid_thw"]
                t, gh, gw = grid
                hm, wm = gh // 2, gw // 2
                self._text_token(self.ids["start_of_image"], fn)
                n_tok = (t * gh * gw) // 4
                self.vit_indexes.extend(range(self.curr, self.curr + n_tok))
                self._emit(n_tok, fn, False, self._grid_pos(t, hm, wm))
                self.rope += max(t, hm, wm) - 1 + 1
                self.vit_patches.append(patches)
                self.vit_grids.append(tuple(grid))
                if item.get("special_token_loss"):
                    self.ce_indexes.append(self.curr)
                    self.ce_weights.append(1.0)
                    self.ce_labels.append(item["special_token_label"])
                self._text_token(self.ids["end_of_image"], fn)
            elif kind == "dino_image":
                view = next(dino_iter)
                fn = self.split  # one shared split id per *sample's* dino set
                img = view["image"]  # (H, W, 3) uint8 or float [0,1]
                c_h, c_w = img.shape[0], img.shape[1]
                p = self.cfg.dino_patch_size
                hp, wp = c_h // p, c_w // p
                self._text_token(self.ids["start_of_image"], fn)
                n_tok = hp * wp
                self.dino_indexes.extend(range(self.curr, self.curr + n_tok))
                self._emit(n_tok, fn, True, self._grid_pos(1, hp, wp))
                self.rope += max(hp, wp) - 1 + 1
                self.dino_images.append(img)
                for k in self.gt:
                    self.gt[k].append(view.get(k))
                n_imgs += 1
                if item.get("special_token_loss"):
                    self.ce_indexes.append(self.curr)
                    self.ce_weights.append(1.0)
                    self.ce_labels.append(item["special_token_label"])
                self._text_token(self.ids["end_of_image"], fn)
            else:
                raise ValueError(kind)

        # dino views of one sample share one full-attention split, vit images
        # get their own (reference attn_modes 'full' per image); text is
        # causal. A fresh split id closes the dino group.
        self.split += 1
        self.doc += 1
        self.sample_lens.append(self.curr - sample_start)
        self.img_per_seq.append(n_imgs)
        if "data_indexes" in sample:
            self.data_indexes.append(sample["data_indexes"])

    # -- finalize -----------------------------------------------------------
    def to_batch(
        self,
        rng: Optional[random.Random] = None,
        sorted_layout: bool = False,
        geo_start_bucket: int = 1,
    ) -> Dict[str, Any]:
        """sorted_layout=True permutes the physical token order to
        [und | padding | geo] so the decoder's SPLIT expert mode can run
        contiguous single-expert matmuls (mot_decoder.SPLIT). Attention
        semantics are unchanged: the TokenInfo `pos` field carries the
        logical order. The batch gains `geo_start` (= S - num_geo_tokens)."""
        cfg = self.cfg
        s = cfg.max_num_tokens
        assert self.curr <= s, (self.curr, s)
        total = self.curr

        doc = np.full(s, -1, np.int32)
        doc[:total] = self.doc_id
        fn = np.full(s, -1, np.int32)
        fn[:total] = self.fn_id
        noise = np.full(s, -1, np.int32)
        pos_meta = np.zeros(s, np.int32)
        pos_meta[:total] = np.arange(total)
        position_ids = np.zeros((3, s), np.int64)
        if self.pos_ids:
            position_ids[:, :total] = np.concatenate(self.pos_ids, axis=1)
        is_geo = np.zeros(s, bool)
        is_geo[:total] = self.is_geo

        c = cfg.max_ce_slots
        nce = len(self.ce_indexes)
        assert nce <= c, (nce, c)
        ce_idx = np.zeros(c, np.int32)
        ce_idx[:nce] = self.ce_indexes
        ce_lab = np.zeros(c, np.int32)
        ce_lab[:nce] = self.ce_labels
        ce_w = np.zeros(c, np.float32)
        ce_w[:nce] = self.ce_weights

        batch: Dict[str, Any] = dict(
            text_ids=np.asarray(self.text_ids, np.int32),
            text_indexes=np.asarray(self.text_indexes, np.int32),
            dino_indexes=np.asarray(self.dino_indexes, np.int32),
            vit_indexes=np.asarray(self.vit_indexes, np.int32),
            is_geo=is_geo,
            position_ids=position_ids,
            doc_id=doc,
            fn_id=fn,
            noise_id=noise,
            pos=pos_meta,
            ce_indexes=ce_idx,
            ce_labels=ce_lab,
            ce_weights=ce_w,
            sample_lens=list(self.sample_lens),
            img_per_seq=list(self.img_per_seq),
            data_indexes=list(self.data_indexes),
        )
        if self.dino_images:
            imgs = np.stack(
                [np.asarray(im, np.float32) for im in self.dino_images]
            )
            if imgs.max() > 1.5:
                imgs = imgs / 255.0
            imgs = imgs.transpose(0, 3, 1, 2)  # NCHW [0,1]
            if rng is not None:
                imgs = apply_cojitter(imgs, rng, self.cfg.cojitter_prob)
            # /255 -> cojitter -> RESNET normalize, the reference order
            # (dataset_base.py:262-289); TrainBatch.dino_images is consumed
            # normalized by the dino encoder
            from .images import resnet_normalize

            batch["dino_images"] = resnet_normalize(imgs)
            for k in ("depths", "extrinsics", "intrinsics", "world_points"):
                if self.gt[k][0] is not None:
                    batch[k] = np.stack(
                        [np.asarray(x, np.float32) for x in self.gt[k]]
                    )
            if self.gt["point_masks"][0] is not None:
                batch["point_masks"] = np.stack(
                    [np.asarray(x, bool) for x in self.gt["point_masks"]]
                )
            batch["view_infos"] = list(self.gt["view_infos"])
            batch["image_paths"] = list(self.gt["image_paths"])
        if self.vit_patches or cfg.max_vit_patches:
            from ..models.qwen_vit import pack_views

            views = [
                {"patches": p, "grid_thw": g}
                for p, g in zip(self.vit_patches, self.vit_grids)
            ]
            pats, coords, seg, n_merged = pack_views(
                views, pad_to=cfg.max_vit_patches, patch_dim=cfg.vit_patch_dim
            )
            batch["vit_patches"] = pats
            batch["vit_coords"] = coords.astype(np.int32)
            batch["vit_seg"] = seg
            batch["vit_grids"] = list(self.vit_grids)
            # pad merged-token scatter targets with s (out of bounds)
            n_slots = pats.shape[0] // 4
            vit_idx = np.full(n_slots, s, np.int32)
            vit_idx[:n_merged] = batch["vit_indexes"]
            batch["vit_indexes"] = vit_idx
        if sorted_layout:
            batch = self._sort_layout(batch, s, geo_start_bucket)
        return batch

    @staticmethod
    def _sort_layout(
        batch: Dict[str, Any], s: int, geo_start_bucket: int = 1
    ) -> Dict[str, Any]:
        is_geo = batch["is_geo"]
        # physical order: und tokens (logical order), padding, then geo
        pad = batch["doc_id"] < 0
        order_key = np.where(pad, 1, np.where(is_geo, 2, 0))
        perm = np.argsort(order_key, kind="stable")  # physical j <- logical perm[j]
        inv = np.empty(s, np.int64)
        inv[perm] = np.arange(s)
        for k in ("doc_id", "fn_id", "noise_id", "pos", "is_geo"):
            batch[k] = batch[k][perm]
        batch["position_ids"] = batch["position_ids"][:, perm]
        for k in ("text_indexes", "dino_indexes", "vit_indexes", "ce_indexes"):
            if len(batch[k]):
                idx = batch[k]
                # vit_indexes may be padded with s (out of bounds = dropped)
                mapped = inv[np.minimum(idx, s - 1)]
                batch[k] = np.where(idx < s, mapped, s).astype(idx.dtype)
        n_und = int((order_key == 0).sum())
        geo_start = int(s - is_geo.sum())
        geo_start = max(n_und, geo_start // geo_start_bucket * geo_start_bucket)
        assert geo_start >= n_und, (geo_start, n_und)
        batch["geo_start"] = geo_start
        return batch


def apply_cojitter(
    imgs: np.ndarray, rng: random.Random, cojitter_prob: float
) -> np.ndarray:
    """Color-jitter/grayscale augmentation, shared across frames with
    probability cojitter_prob else per-frame (reference dataset_base.py:261-273
    + data/augmentation_vggt.py:11-72)."""
    from .augment import random_color_augmentation

    if rng.random() < cojitter_prob:
        seed = rng.randrange(1 << 30)
        return np.stack(
            [random_color_augmentation(im, np.random.default_rng(seed)) for im in imgs]
        )
    return np.stack(
        [
            random_color_augmentation(im, np.random.default_rng(rng.randrange(1 << 30)))
            for im in imgs
        ]
    )


PACKER_STATUS = "_packer"  # the data_status entry that holds the packer's own resume state


def fold_data_status(
    status: Dict[str, Dict], data_indexes: Sequence[Dict]
) -> Dict[str, Dict]:
    """Fold one emitted batch's consumed-sample cursors into a resume-status
    dict {dataset_name: {worker_id: last_consumed_index}} — the shape
    build_groups_from_config(data_status=...) fast-forwards from (reference
    persists per-rank data_status the same way, fsdp_utils.py:478-530).
    Mutates and returns `status`."""
    for di in data_indexes:
        status.setdefault(di["dataset_name"], {})[di["worker_id"]] = di[
            "data_indexes"
        ]
    return status


# samples too long to pack alone, in a row, after which PackedIterableDataset raises
MAX_TOO_LONG_IN_A_ROW = 100


class PackedIterableDataset:
    """Weighted group sampling + packing loop (reference PackedDataset.__iter__,
    dataset_base.py:310-390)."""

    def __init__(
        self,
        groups: Sequence[Dict],  # each: {name, dataset, weight, is_mandatory}
        new_token_ids: Dict[str, int],
        cfg: Optional[PackerConfig] = None,
        group_rng: Optional[random.Random] = None,
        resume: Optional[Dict[str, Any]] = None,
    ):
        """group_rng draws the group of each sample (by default a generator
        seeded with cfg.base_seed); random.Random(n) draws what the JAX
        package's global generator draws after random.seed(n). `resume` is a
        `resume_status()` saved earlier (the datasets themselves are built
        from the same dict, `build_groups_from_config(data_status=...)`): the
        step counter and the group generator continue where that left off."""
        self.groups = list(groups)
        self.cfg = cfg or PackerConfig()
        self.new_token_ids = new_token_ids
        self.step_counter = 0
        self.too_long_in_a_row = 0
        self.epoch_seed = self.cfg.base_seed
        self.group_rng = random.Random(self.cfg.base_seed) if group_rng is None else group_rng
        # the cursors of every sample read from a dataset, {name: {worker: index}}; a status read
        # back from JSON has its worker ids as strings
        self.pulled: Dict[str, Dict] = {
            name: {int(w): i for w, i in cursors.items()}
            for name, cursors in (resume or {}).items() if name != PACKER_STATUS
        }
        state = (resume or {}).get(PACKER_STATUS)
        if state:
            self.step_counter = state["step_counter"]
            version, internal, gauss = state["group_rng"]
            self.group_rng.setstate((version, tuple(internal), gauss))

    def resume_status(self) -> Dict[str, Any]:
        """What a resumed run needs, taken right after a pack was yielded: the
        cursors of every sample read so far, packed or dropped (a sample that
        did not fit the pack it would have ended is dropped, and so are those
        too long alone), and the packer's step counter and group generator.
        JSON-serialisable; the datasets fast-forward from the cursors."""
        version, internal, gauss = self.group_rng.getstate()
        status = {name: dict(cursors) for name, cursors in self.pulled.items()}
        status[PACKER_STATUS] = {"step_counter": self.step_counter, "group_rng": [version, list(internal), gauss]}
        return status

    def _pull(self, it) -> Optional[Dict]:
        sample = next(it)
        if sample is not None and "data_indexes" in sample:
            fold_data_status(self.pulled, [sample["data_indexes"]])
        return sample

    def set_epoch(self, seed: int):
        self.epoch_seed = seed
        for g in self.groups:
            if hasattr(g["dataset"], "set_epoch"):
                g["dataset"].set_epoch(seed)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        weights = [g.get("weight", 1.0) for g in self.groups]
        total_w = sum(weights)
        assert total_w > 0
        cum = np.cumsum(np.asarray(weights) / total_w)
        iters = [iter(g["dataset"]) for g in self.groups]
        packer = SequencePacker(self.cfg, self.new_token_ids)
        lo, hi = self.cfg.image_num_range

        random_image_num = None
        random_ar = None
        while True:
            self.step_counter += 1
            step_seed = self.epoch_seed + self.step_counter
            step_rng = random.Random(step_seed)
            # NB: drawn once per PACK, not per step — the reference redraws
            # per step (dataset_base.py:321-333), which would mix dino view
            # shapes inside one packed batch and break its own np.stack
            # (to_tensor :261); pack-constant draws keep GT stacks dense.
            if random_image_num is None:
                random_image_num = step_rng.randint(lo, hi)
                random_ar = round(
                    step_rng.uniform(*self.cfg.aspect_ratio_range), 2
                )

            def configure(ds):
                if hasattr(ds, "set_random_image_num"):
                    ds.set_random_image_num(random_image_num)
                if hasattr(ds, "set_random_aspect_ratio"):
                    ds.set_random_aspect_ratio(random_ar)
                if hasattr(ds, "set_step_rng"):
                    ds.set_step_rng(step_seed)

            # mandatory groups contribute one sample at the head of each pack
            if packer.curr == 0:
                for gi, g in enumerate(self.groups):
                    if not g.get("is_mandatory"):
                        continue
                    while True:
                        configure(g["dataset"])
                        sample = self._pull(iters[gi])
                        if sample is None:
                            continue
                        if self._fits_alone(sample, g, packer, step_rng, packer.vit_rows):
                            packer.add_sample(sample, step_rng)
                            break

            gi = int(np.searchsorted(cum, self.group_rng.random(), side="right"))
            gi = min(gi, len(self.groups) - 1)
            configure(self.groups[gi]["dataset"])
            sample = self._pull(iters[gi])
            if sample is None:
                continue
            if not self._fits_alone(sample, self.groups[gi], packer, step_rng):
                continue

            cap = self.cfg.max_vit_patches
            if packer.curr + sample["num_tokens"] > self.cfg.max_num_tokens or (
                cap and packer.vit_rows + packer.vit_rows_added(sample, step_rng) > cap
            ):
                yield self._emit(packer, step_rng)
                random_image_num = random_ar = None
                continue
            packer.add_sample(sample, step_rng)
            if packer.curr >= self.cfg.expected_num_tokens:
                yield self._emit(packer, step_rng)
                random_image_num = random_ar = None

    def _emit(self, packer: "SequencePacker", step_rng) -> Dict[str, Any]:
        batch = packer.to_batch(
            step_rng,
            sorted_layout=self.cfg.sorted_layout,
            geo_start_bucket=self.cfg.geo_start_bucket,
        )
        packer.reset()
        return batch

    def _fits_alone(self, sample, group, packer, step_rng, packed_vit_rows: int = 0) -> bool:
        """Whether the sample is short enough to pack: fewer tokens than
        max_num_tokens_per_sample, and ViT patch rows that fit the
        max_vit_patches slots beside `packed_vit_rows`. Raises once
        MAX_TOO_LONG_IN_A_ROW samples in a row were not, since the pack's draws
        (view count, aspect ratio) stay fixed until it is emitted, and the JAX
        packer would then draw forever."""
        cap = self.cfg.max_vit_patches
        rows = packer.vit_rows_added(sample, step_rng) if cap else 0
        if sample["num_tokens"] < self.cfg.max_num_tokens_per_sample and (not cap or packed_vit_rows + rows <= cap):
            self.too_long_in_a_row = 0
            return True
        self.too_long_in_a_row += 1
        if self.too_long_in_a_row >= MAX_TOO_LONG_IN_A_ROW:
            raise ValueError(
                f"PackedIterableDataset: {self.too_long_in_a_row} samples in a row were too long to pack alone, "
                f"the last of {sample['num_tokens']} tokens and {rows} ViT patch rows (beside {packed_vit_rows} "
                f"packed) from group {group['name']!r}, with max_num_tokens_per_sample "
                f"{self.cfg.max_num_tokens_per_sample} (train_torch.py sets it to min(16384, --max_num_tokens // 2)) "
                f"and max_vit_patches {cap}: raise them, or make the samples smaller")
        return False
