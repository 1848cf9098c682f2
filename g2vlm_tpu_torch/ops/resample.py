"""PIL's fixed-point image resampler on the device (csrc/image_resample.cu), its
wrappers, plain versions and launch counters: the chat path's image
preprocessing, bit for bit `data/images.load_views` + `resnet_normalize` and
`data/vit_preprocess.preprocess_vit_image` + `qwen_vit.pack_views`, cast to the
model's dtype.

Pillow resizes an 8-bit image in two separable passes, the horizontal one
first, each only where its axis changes size, with a uint8 image between them
(Resample.c, `ImagingResampleInner`). Each output column (row) reads the input
columns (rows) `xmin .. xmin + n - 1` with int32 taps: the filter's weights
(`precompute_coeffs`, in double precision, the support scaled by
max(in / out, 1)) normalised to sum 1 and rounded to 22 fractional bits
(`normalize_coeffs_8bpc`). The sum starts at 2^21 and is clipped to 0..255
after `>> 22` (`clip8`). `coeffs` repeats that table with Python's `math`
(libm, as Pillow calls it), so the whole resample is integer arithmetic that
any device reproduces exactly. The normalisations after it, x / 255 then
(x - mean) / std in fp32, and the rounding to bf16 / fp16 are single IEEE
operations, so the model inputs are bitwise the host path's.

Kernels (launch counters in `launch_counts`):
- `resample_pass`: one uint8 -> uint8 pass along one axis of a batch of
  (N, H, W, 3) frames of one shape;
- `resample_views`: the last (vertical) pass fused with /255, the RESNET
  normalisation and the cast, stored as (N, 3, H, W): the DINOv2 views;
- `resample_patch_rows`: the last pass fused with /255, the CLIP normalisation
  and the cast, each pixel stored straight into its merge-grouped patch row
  of (P, 3 * 2 * 14 * 14), twice for the temporal repeat; rows of `out` past
  the frames' own are zeroed (pack_views' padding).
A chat request of N uniform frames launches 6 (2 for the views: LANCZOS H, V;
4 for the ViT rows: bicubic to 768 x 768, H, V, then to 756 x 756, H, V).

No TPU kernel is replaced: the JAX package preprocesses on the host with PIL.
These exist because that host work (~77 ms a 480 x 640 view, plus the fp32 ->
bf16 cast and the pageable copy of 13.7 MB of fp32 rows an image) was the
largest block of a chat request while the card waited. What bounds them on
the H100 is bytes and launch latency: four frames read ~3.7 MB and write
~32 MB (~12 us at 3.35 TB/s). The design: one thread a pixel, its three
channels summed in int32 over the taps of a table row that the threads of a
block share; the tables (bounds and taps, int32) are built on the host once
per (in size, out size, filter) and kept on the device, so a request after
warm-up builds none; the normalisation, cast and layout ride on the last pass,
so the fp32 images never exist.

Dispatch: a CUDA tensor launches the kernels or the wrapper raises; a CPU
tensor takes the plain version beside them, the same int32 taps and clip.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import flash_attention as fa

LANCZOS, BICUBIC = "lanczos", "bicubic"
PRECISION_BITS = 32 - 8 - 2  # Resample.c: 22 fractional bits of a tap
# the Qwen2-VL image processor's patch rows (data/vit_preprocess.tile_patches' defaults): 14 x 14 patches,
# 2 x 2 merge groups, each image repeated twice in time
PATCH, MERGE, TEMPORAL = 14, 2, 2
ROW = 3 * TEMPORAL * PATCH * PATCH  # 1176 values a patch row
_SUPPORT = {BICUBIC: 2.0, LANCZOS: 3.0}
_OUT_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# Launches of each kernel; a wrapper adds one exactly where it launches.
launch_counts: Dict[str, int] = {"resample_pass": 0, "resample_views": 0, "resample_patch_rows": 0}

_tables: Dict[Tuple[int, int, str, torch.device], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# the coefficient tables (Resample.c's precompute_coeffs + normalize_coeffs_8bpc)
# ---------------------------------------------------------------------------

def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


_FILTERS = {BICUBIC: _bicubic, LANCZOS: _lanczos}


def coeffs(in_size: int, out_size: int, filt: str) -> np.ndarray:
    """Pillow's table for resizing an axis of `in_size` to `out_size`: an int32
    (out_size, 2 + ksize) array whose row holds xmin, the count n and the ksize
    taps (those past n are 0). The weights in double precision and their
    22-bit rounding follow Resample.c step by step."""
    fn, support = _FILTERS[filt], _SUPPORT[filt]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    out = np.zeros((out_size, 2 + ksize), np.int32)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        out[xx, 0], out[xx, 1] = xmin, xmax
        out[xx, 2:2 + xmax] = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 else int(0.5 + w * (1 << PRECISION_BITS))
                               for w in k]
    return out


def identity_table(size: int) -> np.ndarray:
    """A pass that leaves an axis of `size` as it is (Pillow skips it): one tap of 1.0 a row."""
    out = np.zeros((size, 3), np.int32)
    out[:, 0], out[:, 1], out[:, 2] = np.arange(size), 1, 1 << PRECISION_BITS
    return out


def table(in_size: int, out_size: int, filt: str, device) -> torch.Tensor:
    """`coeffs` (or `identity_table` where the size stays) as a contiguous int32 tensor on `device`,
    built once per (in size, out size, filter, device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (in_size, out_size, filt, device)
    t = _tables.get(key)
    if t is None:
        arr = identity_table(in_size) if in_size == out_size else coeffs(in_size, out_size, filt)
        t = _tables[key] = torch.from_numpy(arr).to(device)
    return t


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def resample_pass_plain(x: torch.Tensor, tab: torch.Tensor, axis: int) -> torch.Tensor:
    """One pass of `tab` over (N, H, W, 3) uint8 along W (axis 2) or H (axis 1): int32 sums from
    2^21, `>> 22`, clipped to 0..255; uint8 out."""
    xi = x.to(torch.int32)
    bounds, taps = tab[:, 0].long(), tab[:, 2:]
    shape = [1, 1, 1, 1]
    shape[axis] = tab.shape[0]
    out_shape = list(x.shape)
    out_shape[axis] = tab.shape[0]
    acc = torch.full(out_shape, 1 << (PRECISION_BITS - 1), dtype=torch.int32, device=x.device)
    for k in range(taps.shape[1]):
        idx = (bounds + k).clamp(max=x.shape[axis] - 1)  # taps past a row's count are 0
        acc += xi.index_select(axis, idx) * taps[:, k].reshape(shape)
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def _normalize_plain(x: torch.Tensor, mean, std, dtype: torch.dtype) -> torch.Tensor:
    """(..., 3) uint8 -> x / 255, then (x - mean) / std, in fp32 and then `dtype`: the host path's
    numpy arithmetic (operands on x's device, so that every division divides: a CUDA tensor over a
    host scalar multiplies by its reciprocal)."""
    def const(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=x.device)

    return ((x.to(torch.float32) / const(255.0) - const(mean)) / const(std)).to(dtype)


def tile_rows_plain(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> merge-grouped patch rows (N gh gw, ROW), as data/vit_preprocess.tile_patches
    lays out each image (the image repeated TEMPORAL times)."""
    n, h, w, c = img.shape
    gh, gw = h // PATCH, w // PATCH
    x = img.permute(0, 3, 1, 2).reshape(n, 1, c, gh // MERGE, MERGE, PATCH, gw // MERGE, MERGE, PATCH)
    x = x.expand(n, TEMPORAL, *x.shape[2:]).permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(n * gh * gw, ROW)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_frames(name: str, frames: torch.Tensor) -> None:
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3 or not frames.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous (N, H, W, 3) uint8, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {frames.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def resample_pass(frames: torch.Tensor, out_size: int, filt: str, axis: int) -> torch.Tensor:
    """One uint8 pass of Pillow's `filt` along W (axis 2) or H (axis 1) of (N, H, W, 3) frames."""
    name = "resample_pass"
    _check_frames(name, frames)
    tab = table(frames.shape[axis], out_size, filt, frames.device)
    if frames.device.type == "cpu":
        return resample_pass_plain(frames, tab, axis)
    n, h, w, _ = frames.shape
    out = torch.empty((n, out_size, w, 3) if axis == 1 else (n, h, out_size, 3), dtype=torch.uint8,
                      device=frames.device)
    if out.numel():
        err = _lib().g2_resample_pass(axis, frames.data_ptr(), out.data_ptr(), tab.data_ptr(), n, h, w, out_size,
                                      tab.shape[1], _stream(frames))
        fa._raise_on_error(name, err)
        launch_counts[name] += 1
    return out


def resize(frames: torch.Tensor, hw: Tuple[int, int], filt: str) -> torch.Tensor:
    """Pillow's `Image.resize((w, h), filt)` of each (N, H, W, 3) uint8 frame: the horizontal pass,
    then the vertical one, each only where its axis changes."""
    if frames.shape[2] != hw[1]:
        frames = resample_pass(frames, hw[1], filt, axis=2)
    if frames.shape[1] != hw[0]:
        frames = resample_pass(frames, hw[0], filt, axis=1)
    return frames


def _last_pass(name: str, frames: torch.Tensor, hw: Tuple[int, int], filt: str, out: torch.Tensor):
    """The horizontal pass where the width changes; then the vertical table (the identity where the
    height stays) that the fused kernel runs."""
    _check_frames(name, frames)
    if out.dtype not in _OUT_DTYPES or out.device != frames.device or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous bf16 / fp16 / fp32 tensor on {frames.device}, got "
                         f"{out.dtype} on {out.device}")
    if frames.shape[2] != hw[1]:
        frames = resample_pass(frames, hw[1], filt, axis=2)
    return frames, table(frames.shape[1], hw[0], filt, frames.device)


def resample_views(frames: torch.Tensor, hw: Tuple[int, int], filt: str, mean: Sequence[float],
                   std: Sequence[float], out: torch.Tensor) -> torch.Tensor:
    """Pillow's resize of (N, H0, W0, 3) uint8 frames to `hw`, then x / 255 and (x - mean) / std in
    fp32 per channel, written to `out` (N, 3, h, w) in its dtype; returns `out`."""
    name = "resample_views"
    n = frames.shape[0]
    if tuple(out.shape) != (n, 3, *hw):
        raise ValueError(f"{name}: out of shape {tuple(out.shape)}, expected {(n, 3, *hw)}")
    frames, tab = _last_pass(name, frames, hw, filt, out)
    if frames.device.type == "cpu":
        x = resample_pass_plain(frames, tab, axis=1)
        out.copy_(_normalize_plain(x, mean, std, out.dtype).permute(0, 3, 1, 2))
        return out
    if out.numel():
        err = _lib().g2_resample_views(
            _OUT_DTYPES[out.dtype], frames.data_ptr(), out.data_ptr(), tab.data_ptr(), n, frames.shape[1], hw[1],
            hw[0], tab.shape[1], *map(float, mean), *map(float, std), _stream(frames))
        fa._raise_on_error(name, err)
        launch_counts[name] += 1
    return out


def resample_patch_rows(frames: torch.Tensor, hw: Tuple[int, int], filt: str, mean: Sequence[float],
                        std: Sequence[float], out: torch.Tensor) -> torch.Tensor:
    """Pillow's resize of (N, H0, W0, 3) uint8 frames to `hw`, then x / 255 and (x - mean) / std in
    fp32, written to `out` (P, ROW) in its dtype as `tile_patches` lays out each frame's rows, the
    frames one after another; `out`'s rows past the frames' own are zeroed. Returns `out`."""
    name = "resample_patch_rows"
    n = frames.shape[0]
    h, w = hw
    rows = n * (h // PATCH) * (w // PATCH)
    if h % (PATCH * MERGE) or w % (PATCH * MERGE):
        raise ValueError(f"{name}: {hw} is not a multiple of {PATCH * MERGE} (smart_resize's sizes are)")
    if out.dim() != 2 or out.shape[1] != ROW or out.shape[0] < rows:
        raise ValueError(f"{name}: out of shape {tuple(out.shape)} for {rows} rows of {ROW}")
    frames, tab = _last_pass(name, frames, hw, filt, out)
    if frames.device.type == "cpu":
        x = _normalize_plain(resample_pass_plain(frames, tab, axis=1), mean, std, out.dtype)
        out[:rows] = tile_rows_plain(x)
        out[rows:] = 0
        return out
    if out.numel():
        err = _lib().g2_resample_patch_rows(
            _OUT_DTYPES[out.dtype], frames.data_ptr(), out.data_ptr(), tab.data_ptr(), n, frames.shape[1], w, h,
            tab.shape[1], *map(float, mean), *map(float, std), PATCH, MERGE, TEMPORAL,
            (out.shape[0] - rows) * ROW, _stream(frames))
        fa._raise_on_error(name, err)
        launch_counts[name] += 1
    return out


def _lib():
    return fa.load_library()[4]
