"""Image resizing (port of g2vlm_tpu/utils/image.py).

The JAX file builds interpolation matrices precisely so that they equal
PyTorch's `F.interpolate(..., align_corners=False, antialias=True)`;
`resize_hw` calls that function directly. `resize_matrix` is the port's own
copy of the matrix builder (host numpy), for the passes that need the matrix
itself: the ViT preprocess resamples in PIL's order with a uint8 lattice
between its two passes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_hw(
    img: torch.Tensor,  # (..., H, W)
    out_hw: Tuple[int, int],
    mode: str = "bilinear",  # or "bicubic"
) -> torch.Tensor:
    """Antialiased resize of the trailing two axes in fp32; an axis whose
    size does not change is left alone."""
    h_in, w_in = img.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    x = img.float().reshape(1, -1, h_in, w_in)
    if h_in != h_out:
        x = F.interpolate(x, size=(h_out, w_in), mode=mode, align_corners=False, antialias=True)
    if w_in != w_out:
        x = F.interpolate(x, size=(h_out, w_out), mode=mode, align_corners=False, antialias=True)
    return x.reshape(*img.shape[:-2], h_out, w_out).to(img.dtype)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


@lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, method: str = "bilinear", antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) float32 weight matrix replicating
    F.interpolate(..., mode=method, align_corners=False, antialias=antialias)."""
    if method in ("bilinear", "linear"):
        kernel, radius = _linear_kernel, 1.0
    elif method in ("bicubic", "cubic"):
        # the antialiased bicubic is Pillow's (A = -0.5); the classic kernel uses A = -0.75
        a = -0.5 if antialias else -0.75
        kernel, radius = (lambda x, _a=a: _cubic_kernel(x, _a)), 2.0
    else:
        raise ValueError(method)
    scale = in_size / out_size
    support_scale = max(scale, 1.0) if antialias else 1.0
    support = radius * support_scale
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support)) + 1
        hi = int(np.floor(center + support)) + 1
        idx = np.arange(lo, hi)
        w = kernel((idx - center) / support_scale)
        if antialias:
            # out-of-range taps are dropped and the rest renormalised (no border replication)
            keep = (idx >= 0) & (idx < in_size)
            idx, w = idx[keep], w[keep]
            s = w.sum()
            if s != 0:
                w = w / s
            W[i, idx] = w
        else:
            # the classic 4-tap path replicates the border; cubic weights already sum to 1
            np.add.at(W[i], np.clip(idx, 0, in_size - 1), w)
    return W.astype(np.float32)
