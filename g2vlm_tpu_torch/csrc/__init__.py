"""The host C++ data path (`datapath.cpp`, a byte-for-byte copy of
g2vlm_tpu/csrc/datapath.cpp, which the port does not import; a test holds the
two files equal), built with g++ at first use into `_build/` (keyed by a hash
of the source and the flags, as the CUDA libraries are) and called through
ctypes.

Two entries are bound, the two the training data path calls:
`color_jitter_f32` (data/augment.py) and `vit_preprocess_u8`
(data/vit_preprocess.py). Unlike the JAX package's loader, which falls back
to numpy bodies without a toolchain, a failed build raises with the
compiler's message: the port has one implementation of each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "datapath.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile datapath.cpp into BUILD_DIR unless the library of this source
    and these flags is there; returns its path. Raises RuntimeError with the
    compiler's output when g++ fails."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"libdatapath_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp], capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not be run to build {_SRC.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {_SRC.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int32
        fp, i32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
        lib.vit_preprocess_u8.argtypes = [
            u8p, i64, i64,  # src, sh, sw
            i64, i64,  # mh, mw: the first resize
            i64, i64,  # th, tw: the smart_resize dims
            fp, fp,  # mean, std
            i64, i64, i64,  # patch, merge, temporal patch
            fp,  # out rows
        ]
        lib.vit_preprocess_u8.restype = None
        lib.color_jitter_f32.argtypes = [fp, i64, i64, i32p, i64, f32, f32, f32, f32, i32]
        lib.color_jitter_f32.restype = None
        _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def vit_preprocess(
    image: np.ndarray,  # (H, W, 3) uint8 RGB
    target_hw=(768, 768),
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """The fused Qwen2-VL preprocess, one C++ pass: bicubic resize to
    `target_hw` (antialiased, PIL's convention), then to the smart_resize
    dims, CLIP normalisation, merge-grouped patch rows. Returns (rows
    (gh*gw, 3*tps*p*p) float32, grid_thw)."""
    from ..data.vit_preprocess import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, smart_resize

    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"vit_preprocess takes an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    mh, mw = target_hw
    th, tw = smart_resize(mh, mw, factor=patch_size * merge_size)
    gh, gw = th // patch_size, tw // patch_size
    rows = np.empty((gh * gw, 3 * temporal_patch_size * patch_size * patch_size), np.float32)
    img = np.ascontiguousarray(image)
    mean = np.ascontiguousarray(OPENAI_CLIP_MEAN, np.float32)
    std = np.ascontiguousarray(OPENAI_CLIP_STD, np.float32)
    get_lib().vit_preprocess_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0], img.shape[1], mh, mw, th, tw,
        _fptr(mean), _fptr(std), patch_size, merge_size, temporal_patch_size, _fptr(rows),
    )
    return rows, (1, gh, gw)


def color_jitter(
    img: np.ndarray,  # (3, H, W) float32 [0,1], modified in place
    ops: np.ndarray,  # order of {0 brightness, 1 contrast, 2 saturation, 3 hue}
    fb: float, fc: float, fs: float, fh: float,
    do_grayscale: bool,
) -> np.ndarray:
    """torchvision ColorJitter's op sequence (a clip to [0, 1] after each op),
    then grayscale if asked, in one pass over a contiguous float32 image."""
    img = np.ascontiguousarray(img, np.float32)
    ops = np.ascontiguousarray(ops, np.int32)
    get_lib().color_jitter_f32(
        _fptr(img), img.shape[1], img.shape[2], ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ops),
        fb, fc, fs, fh, 1 if do_grayscale else 0,
    )
    return img
