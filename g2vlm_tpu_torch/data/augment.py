"""Image augmentation of the training packs (host-side): torchvision's
ColorJitter (brightness / contrast / saturation 0.5, hue 0.1) with p = 0.9,
then random grayscale with p = 0.05.

The port's own copy of g2vlm_tpu/data/augment.py, which it does not import:
the random draws are the JAX package's, in its order, and the pixel work is
the same native pass (csrc `color_jitter_f32`, the C++ source copied byte for
byte). The JAX package keeps a numpy body for machines without g++; the port
has none (a failed build raises). tests/test_torch_datapath_native.py holds
the two equal bit for bit.
"""

from __future__ import annotations

import numpy as np


def random_color_augmentation(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.5,
    contrast: float = 0.5,
    saturation: float = 0.5,
    hue: float = 0.1,
    jitter_p: float = 0.9,
    grayscale_p: float = 0.05,
) -> np.ndarray:
    """img (3, H, W) float [0,1]. torchvision ColorJitter semantics: a random
    order of the four adjustments, factors uniform in [1-x, 1+x], a clip to
    [0, 1] after each. Every draw happens before the native pass."""
    out = img.astype(np.float32)  # astype always copies here
    jit = rng.random() < jitter_p
    ops, fb, fc, fs, fh = np.zeros(0, np.int32), 0.0, 0.0, 0.0, 0.0
    if jit:
        ops = rng.permutation(4)
        fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        fh = rng.uniform(-hue, hue)
    do_gray = rng.random() < grayscale_p
    if jit or do_gray:
        from ..csrc import color_jitter

        return color_jitter(out, ops, fb, fc, fs, fh, do_gray)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
