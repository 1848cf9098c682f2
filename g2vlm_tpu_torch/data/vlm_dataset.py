"""VLM SFT dataset (LLaVA-style JSONL conversations with images or video).

The port's own copy of g2vlm_tpu/data/vlm_dataset.py, which it does not
import; tests/test_torch_data_path.py holds the two equal.

Behavioral spec: reference data/vlm_dataset.py:16-214 (SftJSONLIterableDataset):
JSONL rows with {"image": path|list | "video": path, "conversations":
[{"from": "human"|"gpt", "value": "...<image>..."}]}; Qwen chat template;
loss only on answer spans; per-sample retry-and-skip.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from .distributed import DistributedIterable
from .vit_preprocess import preprocess_vit_image_fast

CHAT_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant"


def conversations_to_elements(conversations: List[Dict]) -> List[Dict]:
    """Split human/gpt turns into text/image elements (reference
    vlm_dataset.py parsing + data_utils.apply_template_qwenvl2)."""
    elements: List[Dict] = [
        {"type": "text", "has_loss": 0, "text": CHAT_SYSTEM}
    ]
    for conv in conversations:
        if conv["from"] == "human":
            parts = re.split(r"(<image>)", conv["value"])
            for part in parts:
                if part == "<image>":
                    elements.append({"type": "image"})
                elif part.strip():
                    elements.append(
                        {"type": "text", "has_loss": 0, "text": part}
                    )
            elements.append({"type": "text", "has_loss": 0, "text": CHAT_SUFFIX})
        else:
            elements.append(
                {"type": "text", "has_loss": 1, "text": "\n" + conv["value"]}
            )
    return elements


class JsonlVlmDataset(DistributedIterable):
    def __init__(
        self,
        dataset_name: str,
        jsonl_paths: List[str],
        tokenizer=None,
        image_root: str = "",
        num_video_frames: int = 8,
        target_hw=(768, 768),
        allow_skip: bool = True,
        **dist_kwargs,
    ):
        super().__init__(dataset_name, **dist_kwargs)
        self.tokenizer = tokenizer
        self.image_root = image_root
        self.num_video_frames = num_video_frames
        self.target_hw = target_hw
        self.allow_skip = allow_skip
        rows = []
        for p in jsonl_paths:
            with open(p) as f:
                rows.extend([(line, p) for line in f if line.strip()])
        self.data_paths = rows
        self.set_epoch()

    def _encode(self, text: str) -> List[int]:
        if self.tokenizer is not None:
            return self.tokenizer.encode(text)
        return [(hash(w) % 5000) + 100 for w in text.split()]

    def _load_images(self, item) -> List:
        import os

        from PIL import Image

        if "video" in item:
            from .video import sample_video_frames

            return sample_video_frames(
                os.path.join(self.image_root, item["video"]),
                self.num_video_frames,
            )
        images = item.get("image", [])
        if isinstance(images, str):
            images = [images]
        return [
            Image.open(os.path.join(self.image_root, p)).convert("RGB")
            for p in images
        ]

    def __iter__(self) -> Iterator[Dict]:
        rows, worker_id = self.get_data_paths_per_worker()
        cursor = self.status_for_worker(worker_id)
        row_start = (cursor + 1) if cursor is not None else 0
        while True:
            for row_idx, (line, _) in enumerate(rows[row_start:], start=row_start):
                try:
                    item = json.loads(line)
                    images = self._load_images(item)
                    elements = conversations_to_elements(item["conversations"])

                    plan, text_ids_list, vit_views = [], [], []
                    num_tokens = 0
                    img_i = 0
                    for el in elements:
                        if el["type"] == "text":
                            ids = self._encode(el["text"])
                            if not ids:
                                continue
                            text_ids_list.append(ids)
                            num_tokens += len(ids) + (1 if el["has_loss"] else 0)
                            plan.append(
                                {"type": "text", "enable_cfg": 0,
                                 "loss": el["has_loss"], "special_token_loss": 0}
                            )
                        else:
                            patches, grid = preprocess_vit_image_fast(
                                images[img_i], target_hw=self.target_hw
                            )
                            img_i += 1
                            vit_views.append(
                                {"patches": patches, "grid_thw": grid}
                            )
                            num_tokens += int(np.prod(grid)) // 4 + 2
                            plan.append(
                                {"type": "vit_image", "enable_cfg": 0,
                                 "loss": 0, "special_token_loss": 0}
                            )
                except Exception:
                    if self.allow_skip:
                        continue
                    raise
                yield dict(
                    plan=plan,
                    text_ids_list=text_ids_list,
                    vit_views=vit_views,
                    num_tokens=num_tokens,
                    data_indexes={
                        "data_indexes": row_idx,
                        "worker_id": worker_id,
                        "dataset_name": self.dataset_name,
                    },
                )
            row_start = 0
