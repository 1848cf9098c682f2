"""The image preprocessing of the reference, from the uint8 frames a request
carries: the recon views (bilinear antialiased resize to the call's width,
RESNET normalisation), the chat views (PIL LANCZOS to width 518) and the
Qwen2-VL ViT rows (PIL bicubic to 768x768, rounding to multiples of 28, CLIP
normalisation, 2x2 merge-grouped patch rows)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

RESNET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
RESNET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def target_hw(h0: int, w0: int, new_width: int, multiple: int = 14) -> Tuple[int, int]:
    return round(h0 * (new_width / w0) / multiple) * multiple, new_width


def _normalise(x: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(RESNET_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(RESNET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def recon_views(frames: torch.Tensor, new_width: int, patch: int = 14) -> torch.Tensor:
    """(N, H0, W0, 3) uint8 -> (N, 3, H, W) float32, resized and normalised."""
    n, h0, w0, _ = frames.shape
    th, tw = target_hw(h0, w0, new_width, patch)
    x = frames.float().div(255.0).permute(0, 3, 1, 2)
    if (th, tw) != (h0, w0):
        if th != h0:
            x = F.interpolate(x, size=(th, w0), mode="bilinear", align_corners=False, antialias=True)
        if tw != w0:
            x = F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=False, antialias=True)
    return _normalise(x)


def chat_views(frames, new_width: int = 518, patch: int = 14) -> np.ndarray:
    """HWC uint8 frames -> (N, 3, H, W) float32 RESNET-normalised, every view
    at the first one's size, resized with PIL LANCZOS."""
    from PIL import Image

    h0, w0 = frames[0].shape[:2]
    th, tw = target_hw(h0, w0, new_width, patch)
    out = np.stack([np.asarray(Image.fromarray(f).resize((tw, th), Image.Resampling.LANCZOS), np.float32) / 255.0
                    for f in frames]).transpose(0, 3, 1, 2)
    return (out - RESNET_MEAN[None, :, None, None]) / RESNET_STD[None, :, None, None]


def _round28(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
             max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    h, w = round(height / factor) * factor, round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h, w = math.floor(height / beta / factor) * factor, math.floor(width / beta / factor) * factor
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h, w = math.ceil(height * beta / factor) * factor, math.ceil(width * beta / factor) * factor
    return h, w


def vit_rows(frame: np.ndarray, stage: Tuple[int, int] = (768, 768), patch: int = 14):
    """One HWC uint8 frame -> (patch rows (gh*gw, 3*2*p*p), (1, gh, gw))."""
    from PIL import Image

    im = Image.fromarray(frame).resize((stage[1], stage[0]), Image.Resampling.BICUBIC)
    rh, rw = _round28(*stage)
    if (rh, rw) != tuple(stage):
        im = im.resize((rw, rh), Image.Resampling.BICUBIC)
    x = ((np.asarray(im, np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)
    c, h, w = x.shape
    gh, gw = h // patch, w // patch
    t = np.stack([x, x]).reshape(1, 2, c, gh // 2, 2, patch, gw // 2, 2, patch)
    rows = t.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8).reshape(gh * gw, c * 2 * patch * patch)
    return rows, (1, gh, gw)
