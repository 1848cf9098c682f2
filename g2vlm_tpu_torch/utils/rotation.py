"""Rotation representation conversions (quaternion/matrix/axis-angle) and the
Umeyama similarity alignment: the port's own copy of g2vlm_tpu/utils/rotation.py
(numpy), which it does not import.

Behavioral spec: reference modeling/g2vlm/rotation_utils.py (PyTorch3D-derived
conversions used by the camera metrics) and data/dataset_utils_vggt.py
(umeyama; :45-657)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .metrics import matrix_to_quaternion  # (N,3,3) -> (N,4) wxyz


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz -> (N, 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.empty((len(q), 3, 3))
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y - z * w)
    m[:, 0, 2] = 2 * (x * z + y * w)
    m[:, 1, 0] = 2 * (x * y + z * w)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z - x * w)
    m[:, 2, 0] = 2 * (x * z - y * w)
    m[:, 2, 1] = 2 * (y * z + x * w)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def standardize_quaternion(q: np.ndarray) -> np.ndarray:
    """Flip sign so w >= 0 (reference rotation_utils convention)."""
    return np.where(q[..., :1] < 0, -q, q)


def axis_angle_to_matrix(axis_angle: np.ndarray) -> np.ndarray:
    """(N, 3) rotation vectors -> (N, 3, 3) via Rodrigues."""
    aa = np.asarray(axis_angle, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(theta, 1e-12)
    k = np.zeros((len(aa), 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axis[:, 1], axis[:, 0]
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), k.shape)
    return eye + np.sin(t) * k + (1 - np.cos(t)) * (k @ k)


def matrix_to_axis_angle(m: np.ndarray) -> np.ndarray:
    q = standardize_quaternion(matrix_to_quaternion(m))
    w = np.clip(q[:, 0], -1.0, 1.0)
    theta = 2 * np.arccos(w)
    s = np.sqrt(np.maximum(1 - w * w, 1e-12))
    axis = q[:, 1:] / s[:, None]
    return axis * theta[:, None]


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform dst ~ s R src + t
    (reference dataset_utils_vggt.py umeyama). src/dst (N, 3)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    r = u @ s_fix @ vt
    if with_scale:
        var_s = (sc ** 2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s_fix) / var_s)
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return r, t, scale
