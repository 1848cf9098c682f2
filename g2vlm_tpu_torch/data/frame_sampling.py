"""Pose-based frame sampling utilities.

The port's own copy of g2vlm_tpu/data/frame_sampling.py, which it does not import;
tests/test_torch_data_path.py holds the two equal.

Behavioral spec: reference data/frame_sampling_utils.py:1-129 (duplicated as
modeling/g2vlm/frame_sample_utils.py): pairwise extrinsic distance =
normalized rotation angle + lambda_t * camera-center distance, with optional
center-scale normalization; ranking = per-row argsort."""

from __future__ import annotations

import numpy as np


def rotation_angle_deg(r1: np.ndarray, r2: np.ndarray) -> float:
    r = r1.T @ r2
    val = np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)
    return float(np.degrees(np.arccos(val)))


def extrinsic_distance(e1: np.ndarray, e2: np.ndarray, lambda_t: float = 1.0) -> float:
    rot = rotation_angle_deg(e1[:3, :3], e2[:3, :3]) / 180.0
    trans = float(np.linalg.norm(e1[:3, 3] - e2[:3, 3]))
    return rot + lambda_t * trans


def extrinsic_distance_batch(
    extrinsics: np.ndarray, lambda_t: float = 1.0, chunk_size: int = 1000
) -> np.ndarray:
    """(N, 4, 4) -> (N, N) pairwise distances, blocked to bound memory
    (the reference's chunked variant is used above 6000 frames)."""
    r = extrinsics[:, :3, :3].astype(np.float32)
    t = extrinsics[:, :3, 3].astype(np.float32)
    n = len(r)
    dists = np.empty((n, n), np.float32)
    rt = r.transpose(0, 2, 1)
    for i0 in range(0, n, chunk_size):
        i1 = min(n, i0 + chunk_size)
        for j0 in range(0, n, chunk_size):
            j1 = min(n, j0 + chunk_size)
            m = rt[i0:i1, None] @ r[None, j0:j1]
            tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
            ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1))) / 180.0
            td = np.linalg.norm(
                t[i0:i1, None, :] - t[None, j0:j1, :], axis=-1
            )
            dists[i0:i1, j0:j1] = ang + lambda_t * td
    return dists


def compute_ranking(
    extrinsics: np.ndarray, lambda_t: float = 1.0, normalize: bool = True
):
    """-> (ranking (N, N) argsorted neighbor ids, dists (N, N))."""
    ex = np.array(extrinsics, np.float32, copy=True)
    if normalize:
        centers = ex[:, :3, 3]
        scale = np.mean(np.linalg.norm(centers, axis=1))
        if scale > 0:
            ex[:, :3, 3] = ex[:, :3, 3] / scale
    dists = extrinsic_distance_batch(ex, lambda_t=lambda_t)
    return np.argsort(dists, axis=1), dists
