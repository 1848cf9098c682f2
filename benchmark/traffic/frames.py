"""Seeded pools of uint8 frames, made in bulk on the host: each frame is a
random low-resolution image (one value per 8x8 block and channel) scaled up,
so that every call sees distinct, deterministic pixels."""

from __future__ import annotations

import numpy as np


def pool(rng: np.random.Generator, n: int, height: int, width: int, block: int = 8) -> np.ndarray:
    """(n, height, width, 3) uint8."""
    low = rng.integers(0, 256, size=(n, -(-height // block), -(-width // block), 3), dtype=np.uint8)
    return np.repeat(np.repeat(low, block, axis=1), block, axis=2)[:, :height, :width]
