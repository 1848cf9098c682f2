"""On-device image preprocessing (port of g2vlm_tpu/data/device_preprocess.py,
recon views only): uint8 frames go to the device once, then cast ->
antialiased bilinear resize -> RESNET normalisation run there."""

from __future__ import annotations

from typing import Tuple

import torch

from .images import RESNET_MEAN, RESNET_STD

from ..utils.image import resize_hw


def target_hw(h0: int, w0: int, new_width: int = 518, multiple: int = 14) -> Tuple[int, int]:
    """Same shape rule as the host loader: width `new_width`, height scaled
    and rounded to a multiple of `multiple`."""
    th = round(h0 * (new_width / w0) / multiple) * multiple
    return th, new_width


def preprocess_views_device(
    frames: torch.Tensor,  # (N, H0, W0, 3) uint8, on the device
    out_hw: Tuple[int, int],
) -> torch.Tensor:
    """-> (N, 3, H, W) float32, resized and RESNET-normalized."""
    x = frames.float().div_(255.0).permute(0, 3, 1, 2)
    x = resize_hw(x, out_hw, mode="bilinear")
    mean = torch.as_tensor(RESNET_MEAN, device=x.device)[None, :, None, None]
    std = torch.as_tensor(RESNET_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std
