"""On-device image preprocessing (port of g2vlm_tpu/data/device_preprocess.py):
uint8 frames go to the device once; the recon views are cast -> antialiased
bilinear resize -> RESNET normalisation there, and the Qwen2-VL ViT's patch
rows are PIL-order bicubic -> CLIP normalisation -> merge-grouped tiling."""

from __future__ import annotations

from typing import Tuple

import torch

from .images import RESNET_MEAN, RESNET_STD
from .vit_preprocess import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, smart_resize

from ..utils.image import resize_hw, resize_matrix


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


def _pil_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """PIL-order bicubic resize of (..., H, W) in 0..255: horizontal pass,
    uint8 lattice, vertical pass, uint8 lattice (PIL resamples horizontally
    first and materialises a uint8 image after each pass)."""

    def lattice(t):
        return torch.round(torch.clamp(t, 0.0, 255.0))

    h_in, w_in = x.shape[-2:]
    h_out, w_out = out_hw
    if w_in != w_out:
        ww = torch.from_numpy(resize_matrix(w_in, w_out, "bicubic", True)).to(x.device)
        x = lattice(torch.einsum("ow,...hw->...ho", ww, x))
    if h_in != h_out:
        wh = torch.from_numpy(resize_matrix(h_in, h_out, "bicubic", True)).to(x.device)
        x = lattice(torch.einsum("oh,...hw->...ow", wh, x))
    return x


def vit_device_grid(
    stage_hw: Tuple[int, int] = (768, 768), patch_size: int = 14, merge_size: int = 2
) -> Tuple[int, int, int]:
    """grid_thw that the device ViT preprocess produces for every frame."""
    rh, rw = smart_resize(*stage_hw, factor=patch_size * merge_size)
    return (1, rh // patch_size, rw // patch_size)


def preprocess_vit_frames_device(
    frames: torch.Tensor,  # (N, H0, W0, 3) uint8, on the device
    stage_hw: Tuple[int, int] = (768, 768),
    patch_size: int = 14,
    merge_size: int = 2,
    pad_to: int = 0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 frames -> flattened Qwen2-VL patch rows (P, 1176) on the device,
    mirroring the host `preprocess_vit_image` in pass order and uint8 lattice;
    what remains is PIL's fixed-point tap arithmetic (<= 2/255 per pass)."""
    x = frames.float().permute(0, 3, 1, 2)  # 0..255, (N, C, H0, W0)
    rh, rw = smart_resize(*stage_hw, factor=patch_size * merge_size)
    for out_hw in (tuple(stage_hw),) if (rh, rw) == tuple(stage_hw) else (tuple(stage_hw), (rh, rw)):
        x = _pil_bicubic(x, out_hw)
    x = x * (1.0 / 255.0)
    mean = torch.as_tensor(OPENAI_CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.as_tensor(OPENAI_CLIP_STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std

    # batched tile_patches: a single image repeats temporally to fill the 2-frame temporal patch
    n, c, h, w = x.shape
    m, p, tps = merge_size, patch_size, 2
    gh, gw = h // p, w // p
    f = torch.stack([x, x], dim=1).reshape(n, tps, c, gh // m, m, p, gw // m, m, p)
    flat = f.permute(0, 3, 6, 4, 7, 2, 1, 5, 8).reshape(n * gh * gw, c * tps * p * p).to(out_dtype)
    if pad_to and pad_to > flat.shape[0]:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad_to - flat.shape[0]))
    return flat
