"""Image corruption augmentations + edge-constrained resize transforms.

The port's own copy of g2vlm_tpu/data/corruption.py, which it does not import;
tests/test_torch_data_helpers.py holds the two equal.

Behavioral spec: reference data/transforms.py:180-377 — ImageTransform
(max-long-edge/min-short-edge stride-aligned resize + [-1,1] normalize) and
the corruption functions (decolorization, downscale, random crop, motion
blur, patch shuffle, inpainting blanks). cv2's motion blur is replaced with
a numpy rotated-line kernel convolution."""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np


def max_long_edge_min_short_edge_resize(
    image, max_size: int, min_size: int, stride: int, max_pixels: Optional[int] = None
):
    """Scale so long edge <= max_size and short edge >= min_size, rounding to
    stride multiples (reference MaxLongEdgeMinShortEdgeResize)."""
    from PIL import Image

    w, h = image.size
    scale = min(max_size / max(w, h), 1.0)
    scale = max(scale, min_size / min(w, h))
    tw = max(stride, int(round(w * scale / stride)) * stride)
    th = max(stride, int(round(h * scale / stride)) * stride)
    if max_pixels is not None and tw * th > max_pixels:
        shrink = (max_pixels / (tw * th)) ** 0.5
        tw = max(stride, int(tw * shrink / stride) * stride)
        th = max(stride, int(th * shrink / stride) * stride)
    return image.resize((tw, th), Image.Resampling.BICUBIC)


def image_transform(image, max_image_size: int, min_image_size: int,
                    image_stride: int, max_pixels: Optional[int] = None,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """(reference ImageTransform, transforms.py:180-205) -> (3, H, W) float."""
    img = max_long_edge_min_short_edge_resize(
        image, max_image_size, min_image_size, image_stride, max_pixels
    )
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(mean)) / np.asarray(std)
    return arr.transpose(2, 0, 1).astype(np.float32)


def decolorization(image):
    from PIL import Image

    gray = image.convert("L")
    return Image.merge("RGB", [gray] * 3) if image.mode == "RGB" else gray


def downscale(image, scale_factor: float):
    from PIL import Image

    nw = max(1, int(round(image.width * scale_factor)))
    nh = max(1, int(round(image.height * scale_factor)))
    return image.resize((nw, nh), resample=Image.Resampling.BICUBIC)


def random_crop(image, crop_hw: Tuple[int, int]):
    th, tw = crop_hw
    w, h = image.size
    if th > h or tw > w:
        raise ValueError("Crop size exceeds image dimensions")
    x = random.randint(0, w - tw)
    y = random.randint(0, h - th)
    return image.crop((x, y, x + tw, y + th)), [[x, y], [x + tw, y + th]]


def motion_blur(image, kernel_size: int = 15, angle: float = 0.0):
    """Directional blur with a rotated line kernel (reference
    motion_blur_opencv, without cv2)."""
    from PIL import Image

    k = kernel_size
    c = (k - 1) / 2.0
    theta = np.deg2rad(angle)
    d = np.array([np.cos(theta), -np.sin(theta)])
    ys, xs = np.mgrid[0:k, 0:k]
    # distance of each cell from the line through the center along d
    rel = np.stack([xs - c, ys - c], axis=-1)
    perp = np.abs(rel[..., 0] * d[1] - rel[..., 1] * d[0])
    along = np.abs(rel[..., 0] * d[0] + rel[..., 1] * d[1])
    kern = ((perp <= 0.5) & (along <= c + 0.5)).astype(np.float32)
    kern /= max(kern.sum(), 1.0)

    img = np.asarray(image, np.float32)
    pad = k // 2
    out = np.empty_like(img)
    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    for ch in range(img.shape[2]):
        acc = np.zeros(img.shape[:2], np.float32)
        for dy in range(k):
            for dx in range(k):
                wgt = kern[dy, dx]
                if wgt:
                    acc += wgt * padded[dy : dy + img.shape[0], dx : dx + img.shape[1], ch]
        out[..., ch] = acc
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def _split_patches(image, num_splits):
    hs, ws = num_splits
    w, h = image.size
    phs = [h // hs] * (hs - 1) + [h - (h // hs) * (hs - 1)]
    pws = [w // ws] * (ws - 1) + [w - (w // ws) * (ws - 1)]
    patches = []
    y = 0
    for ph in phs:
        x = 0
        for pw in pws:
            patches.append(image.crop((x, y, x + pw, y + ph)))
            x += pw
        y += ph
    return patches, phs, pws


def shuffle_patch(image, num_splits, gap_size: int = 2):
    """Shuffled patch grid with gaps (reference shuffle_patch)."""
    from PIL import Image

    patches, phs, pws = _split_patches(image, num_splits)
    random.shuffle(patches)
    hs, ws = num_splits
    tw = sum(pws) + (ws - 1) * gap_size
    th = sum(phs) + (hs - 1) * gap_size
    out = Image.new(image.mode, (tw, th), color=(255, 255, 255))
    idx, y = 0, 0
    for ph in phs:
        x = 0
        for pw in pws:
            out.paste(patches[idx], (x, y))
            x += pw + gap_size
            idx += 1
        y += ph + gap_size
    return out


def inpainting(image, num_splits, blank_ratio: float = 0.3,
               blank_color=(255, 255, 255)):
    """Blank random patches in place (reference inpainting)."""
    from PIL import Image

    patches, phs, pws = _split_patches(image, num_splits)
    n = len(patches)
    blank = set(random.sample(range(n), max(0, min(int(n * blank_ratio), n))))
    out = Image.new("RGB", image.size)
    idx, y = 0, 0
    for ph in phs:
        x = 0
        for pw in pws:
            p = Image.new("RGB", (pw, ph), blank_color) if idx in blank else patches[idx]
            out.paste(p, (x, y))
            x += pw
            idx += 1
        y += ph
    return out
