"""Joint image/depthmap crop & rescale with intrinsics updates (DUSt3R-style).

The port's own copy of g2vlm_tpu/data/cropping.py, which it does not import;
tests/test_torch_data_path.py holds the two equal.

Behavioral spec: reference modeling/pi3/utils/cropping.py:21-208 — principal-
point-centered crops, Lanczos/bicubic rescale, nearest-neighbor depth resize,
COLMAP<->OpenCV principal-point convention when scaling, bbox derivation from
input/output intrinsics. cv2 is replaced with numpy nearest resampling."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def opencv_to_colmap_intrinsics(k: np.ndarray) -> np.ndarray:
    k = k.copy()
    k[0, 2] += 0.5
    k[1, 2] += 0.5
    return k


def colmap_to_opencv_intrinsics(k: np.ndarray) -> np.ndarray:
    k = k.copy()
    k[0, 2] -= 0.5
    k[1, 2] -= 0.5
    return k


def nearest_resize(arr: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST-equivalent resize of (H, W[, C]) arrays."""
    out_w, out_h = out_wh
    h, w = arr.shape[:2]
    ys = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    return arr[ys][:, xs]


def camera_matrix_of_crop(
    input_k: np.ndarray,
    input_resolution,
    output_resolution,
    scaling: float = 1.0,
    offset_factor: float = 0.5,
    offset=None,
) -> np.ndarray:
    margins = np.asarray(input_resolution) * scaling - np.asarray(output_resolution)
    assert np.all(margins >= 0.0), margins
    if offset is None:
        offset = offset_factor * margins
    out = opencv_to_colmap_intrinsics(input_k)
    out[:2, :] *= scaling
    out[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(out)


def crop_image_depthmap(image, depthmap, k: np.ndarray, crop_bbox):
    """PIL image + (H, W) depth + intrinsics -> cropped triple."""
    l, t, r, b = crop_bbox
    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    k = k.copy()
    k[0, 2] -= l
    k[1, 2] -= t
    return image, depthmap, k


def rescale_image_depthmap(image, depthmap, k: np.ndarray, output_resolution):
    """Rescale so image covers output_resolution (reference
    rescale_image_depthmap): Lanczos when downscaling, bicubic upscaling;
    depth via nearest."""
    from PIL import Image

    input_resolution = np.array(image.size)  # (W, H)
    output_resolution = np.asarray(output_resolution)
    scale_final = max(output_resolution / image.size) + 1e-8
    out = np.floor(input_resolution * scale_final).astype(int)
    resample = (
        Image.Resampling.LANCZOS if scale_final < 1 else Image.Resampling.BICUBIC
    )
    image = image.resize(tuple(out), resample=resample)
    if depthmap is not None:
        depthmap = nearest_resize(depthmap, tuple(out))
    k = camera_matrix_of_crop(k, input_resolution, out, scaling=scale_final)
    return image, depthmap, k


def center_crop_image_depthmap(image, depthmap, k: np.ndarray, crop_scale: float):
    assert 0 < crop_scale <= 1
    input_resolution = np.array(image.size)
    output_resolution = np.floor(input_resolution * crop_scale).astype(int)
    margins = input_resolution - output_resolution
    l, t = (margins / 2).astype(int)
    r = l + output_resolution[0]
    b = t + output_resolution[1]
    return crop_image_depthmap(image, depthmap, k, (l, t, r, b))


def bbox_from_intrinsics_in_out(k_in: np.ndarray, k_out: np.ndarray, out_res):
    out_w, out_h = out_res
    l, t = np.int32(np.round(k_in[:2, 2] - k_out[:2, 2]))
    return (l, t, l + out_w, t + out_h)


def crop_resize_with_intrinsics(
    image,
    depthmap: Optional[np.ndarray],
    intrinsics: np.ndarray,
    resolution,
    aug_crop: int = 0,
    aug_focal: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    info: str = "",
):
    """Full pipeline of the reference _crop_resize_if_necessary
    (recon_dataset.py:254-304): principal-point-centered crop -> optional
    focal augmentation -> rescale -> intrinsics-guided final crop.
    resolution is (W, H)."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(image)
    rng = rng or np.random.default_rng()

    w, h = image.size
    cx, cy = np.round(intrinsics[:2, 2]).astype(int)
    mx = min(cx, w - cx)
    my = min(cy, h - cy)
    assert mx > w / 5, f"bad principal point x in {info}"
    assert my > h / 5, f"bad principal point y in {info}"
    image, depthmap, k = crop_image_depthmap(
        image, depthmap, intrinsics, (cx - mx, cy - my, cx + mx, cy + my)
    )

    target_resolution = np.array(resolution)
    if aug_focal:
        crop_scale = aug_focal + (1.0 - aug_focal) * rng.beta(0.5, 0.5)
        image, depthmap, k = center_crop_image_depthmap(image, depthmap, k, crop_scale)
    if aug_crop > 1:
        target_resolution = target_resolution + rng.integers(0, aug_crop)
    image, depthmap, k = rescale_image_depthmap(image, depthmap, k, target_resolution)

    k2 = camera_matrix_of_crop(k, image.size, resolution, offset_factor=0.5)
    bbox = bbox_from_intrinsics_in_out(k, k2, resolution)
    image, depthmap, k2 = crop_image_depthmap(image, depthmap, k, bbox)
    return image, depthmap, k2
