"""Recon inference pipeline (port of g2vlm_tpu/inference/pipeline.py, recon
entry points): `recon_from_frames` takes decoded uint8 frames, moves them to
the model's device once, preprocesses them there and runs the packed
prefill and the heads, returning the outputs on the device."""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import G2VLMConfig
from ..data.images import resnet_normalize

from ..data.device_preprocess import preprocess_views_device, target_hw
from ..models.g2vlm import G2VLM, PackedPrefill, SequenceBuilder, recon_forward

RECON_PROMPT = "Reconstruct the 3D scene."


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class G2VLMPipeline:
    """Owns the model and the config for recon."""

    def __init__(
        self,
        model: G2VLM,
        cfg: G2VLMConfig,
        new_token_ids: Optional[Dict[str, int]] = None,
        seq_pad_multiple: int = 256,
    ):
        self.model = model
        self.cfg = cfg
        self.new_token_ids = new_token_ids or dict(
            bos_token_id=151644, eos_token_id=151645,
            start_of_image=151652, end_of_image=151653,
        )
        self.seq_pad_multiple = seq_pad_multiple

    def _encode_text(self, text: str, add_bos: bool = False) -> List[int]:
        """Deterministic fake token ids (the JAX pipeline's rule without a
        tokenizer; crc32, not hash(): str hash is randomized per process).
        The tokenizer comes with the chat path."""
        ids = [(zlib.crc32(w.encode()) % 5000) + 100 for w in text.split()]
        if add_bos:
            ids = [self.new_token_ids["bos_token_id"]] + ids
        return ids

    def build_recon_prefill(self, n_views: int, hp: int, wp: int, prompt: str = RECON_PROMPT) -> PackedPrefill:
        b = SequenceBuilder(self.new_token_ids["start_of_image"], self.new_token_ids["end_of_image"])
        b.add_text(self._encode_text(prompt, add_bos=True))
        b.add_dino_images(n_views, hp, wp)
        return b.build(pad_to=_round_up(b.curr, self.seq_pad_multiple))

    def _recon(self, normed: torch.Tensor, prompt: str) -> Dict[str, torch.Tensor]:
        n, _, h, w = normed.shape
        p = self.cfg.dino_patch_size
        prefill = self.build_recon_prefill(n, h // p, w // p, prompt)
        return recon_forward(self.model, prefill, normed.to(self.model.dtype), self.cfg)

    @torch.inference_mode()
    def recon_from_views(self, views: np.ndarray, prompt: str = RECON_PROMPT) -> Dict[str, torch.Tensor]:
        """Recon on preloaded [0, 1] views (N, 3, H, W); outputs stay on the device."""
        normed = torch.as_tensor(resnet_normalize(views), dtype=torch.float32).to(self.model.device)
        return self._recon(normed, prompt)

    @torch.inference_mode()
    def recon_from_frames(
        self,
        frames,  # (N, H0, W0, 3) uint8 decoded frames, numpy or tensor
        prompt: str = RECON_PROMPT,
        new_width: int = 518,
    ) -> Dict[str, torch.Tensor]:
        """Recon straight from uint8 frames: one upload of the raw bytes, then
        cast -> antialiased bilinear resize -> RESNET normalisation -> packed
        prefill -> heads on the device. Returns points, local_points,
        camera_poses and global_points on the device."""
        frames = torch.as_tensor(frames).to(self.model.device)
        n, h0, w0, _ = frames.shape
        th, tw = target_hw(h0, w0, new_width, self.cfg.dino_patch_size)
        return self._recon(preprocess_views_device(frames, (th, tw)), prompt)
