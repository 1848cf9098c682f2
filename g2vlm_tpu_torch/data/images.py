"""Host-side image loading (the port's own copy of g2vlm_tpu/data/images.py,
which it does not import): PIL LANCZOS resize to width `new_width` with the
height rounded to the nearest multiple of 14, [0, 1] scaling; RESNET
normalization happens on the device."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

RESNET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
RESNET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def load_views(
    images: Sequence,
    new_width: int = 518,
    patch_multiple: int = 14,
) -> np.ndarray:
    """paths / PIL images / HWC uint8 arrays -> (N, 3, H, W) float32 in [0,1].

    All views are resized to the FIRST view's target shape."""
    from PIL import Image

    pils: List = []
    for im in images:
        if isinstance(im, str):
            pils.append(Image.open(im).convert("RGB"))
        elif isinstance(im, np.ndarray):
            pils.append(Image.fromarray(im))
        else:
            pils.append(im.convert("RGB") if im.mode != "RGB" else im)

    w0, h0 = pils[0].size
    if new_width is None:
        tw = max(1, round(w0 / patch_multiple)) * patch_multiple
        th = max(1, round(h0 / patch_multiple)) * patch_multiple
    else:
        tw = new_width
        th = round(h0 * (new_width / w0) / patch_multiple) * patch_multiple

    out = np.stack(
        [
            np.asarray(p.resize((tw, th), Image.Resampling.LANCZOS), np.float32)
            / 255.0
            for p in pils
        ]
    )
    return out.transpose(0, 3, 1, 2)


def resnet_normalize(images: np.ndarray) -> np.ndarray:
    """(N, 3, H, W) [0,1] -> RESNET-normalized."""
    return (images - RESNET_MEAN[None, :, None, None]) / RESNET_STD[
        None, :, None, None
    ]
