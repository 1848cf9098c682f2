"""Host-side Qwen2-VL image preprocessing (the port's own copy of
g2vlm_tpu/data/vit_preprocess.py, which it does not import; a test holds the
two equal): PIL bicubic resize to 768x768, `smart_resize` to multiples of 28,
CLIP normalisation, merge-grouped patch rows. `preprocess_vit_image_fast`, the
training data path's form, is one pass of the C++ data path (csrc
`vit_preprocess_u8`, the JAX package's source copied byte for byte), bitwise
the JAX package's native output (tests/test_torch_datapath_native.py)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    """Round to multiples of `factor` while keeping the pixel count in range."""
    if height < factor or width < factor:
        raise ValueError(f"height/width must exceed factor {factor}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def tile_patches(
    img: np.ndarray,  # (C, H, W) normalized
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flatten into merge-grouped patch rows. A single image is repeated
    temporally to fill the temporal patch."""
    frames = np.stack([img] * temporal_patch_size)  # (tps, C, H, W)
    c, h, w = img.shape
    gt = 1
    gh, gw = h // patch_size, w // patch_size
    m, p = merge_size, patch_size
    x = frames.reshape(gt, temporal_patch_size, c, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(gt * gh * gw, c * temporal_patch_size * p * p)
    return flat, (gt, gh, gw)


def _to_rgb_pil(image):
    from PIL import Image

    if isinstance(image, str):
        return Image.open(image).convert("RGB")
    if isinstance(image, np.ndarray):
        return Image.fromarray(image)
    return image if image.mode == "RGB" else image.convert("RGB")


def preprocess_vit_image(
    image,
    target_hw: Tuple[int, int] = (768, 768),
    patch_size: int = 14,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Path, PIL image or HWC uint8 array -> (flattened patch rows, grid_thw)."""
    from PIL import Image

    image = _to_rgb_pil(image).resize((target_hw[1], target_hw[0]), Image.Resampling.BICUBIC)
    h, w = image.size[1], image.size[0]
    rh, rw = smart_resize(h, w, factor=patch_size * merge_size)
    if (rh, rw) != (h, w):
        image = image.resize((rw, rh), Image.Resampling.BICUBIC)
    arr = np.asarray(image, np.float32) / 255.0  # (H, W, C)
    arr = (arr - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    return tile_patches(arr.transpose(2, 0, 1), patch_size, merge_size)


def preprocess_vit_image_fast(
    image,
    target_hw: Tuple[int, int] = (768, 768),
    patch_size: int = 14,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """The training data path's preprocess: one fused C++ pass (resize,
    normalise, patch rows; csrc `vit_preprocess_u8`). The resample is PIL's
    antialiased Keys bicubic accumulated in float, so the rows sit within
    ~1/255 of `preprocess_vit_image`'s, which serving keeps. As in the JAX
    package, G2VLM_NATIVE_VIT=0 takes `preprocess_vit_image` instead, and so
    does an input that is no RGB image (path, PIL image or HWC uint8 array)."""
    import os

    if os.environ.get("G2VLM_NATIVE_VIT", "1") == "1":
        arr = None
        if isinstance(image, str):
            from PIL import Image

            arr = np.asarray(Image.open(image).convert("RGB"))
        elif isinstance(image, np.ndarray) and image.dtype == np.uint8:
            arr = image
        elif hasattr(image, "convert"):
            arr = np.asarray(image.convert("RGB"))
        if arr is not None and arr.ndim == 3 and arr.shape[2] == 3:
            from ..csrc import vit_preprocess

            return vit_preprocess(arr, target_hw, patch_size, merge_size)
    return preprocess_vit_image(image, target_hw, patch_size, merge_size)
