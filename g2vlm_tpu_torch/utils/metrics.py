"""Camera-pose evaluation metrics (VGGT-style): the port's own copy of
g2vlm_tpu/utils/metrics.py (numpy), which it does not import.

Behavioral spec: reference modeling/g2vlm/metric.py:1-260 (+ the
PyTorch3D-derived quaternion conversion in rotation_utils.py). Pure
numpy — no PyTorch3D camera objects; inputs are (N, 4, 4) world-to-view
SE(3) matrices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotation -> (N, 4) quaternion (w, x, y, z), PyTorch3D
    convention (reference rotation_utils.py)."""
    m = np.asarray(m, np.float64)
    n = m.shape[0]
    q = np.zeros((n, 4))
    tr = np.trace(m, axis1=-2, axis2=-1)
    for i in range(n):
        r = m[i]
        t = tr[i]
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q[i] = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                    (r[1, 0] - r[0, 1]) / s]
        elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            q[i] = [(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                    (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        elif r[1, 1] > r[2, 2]:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            q[i] = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                    0.25 * s, (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            q[i] = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                    (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    return q


def rotation_angle_deg(rot_a: np.ndarray, rot_b: np.ndarray, eps=1e-15):
    """Quaternion-based relative rotation angle in degrees (reference
    metric.py rotation_angle)."""
    qa = matrix_to_quaternion(rot_a)
    qb = matrix_to_quaternion(rot_b)
    loss_q = np.clip(1 - np.sum(qa * qb, axis=1) ** 2, eps, None)
    err_q = np.arccos(np.clip(1 - 2 * loss_q, -1.0, 1.0))
    return err_q * 180 / np.pi


def translation_angle_deg(t_a, t_b, eps=1e-15, ambiguity=True):
    """Angle between normalized translations, up-to-sign (reference
    metric.py translation_angle / compare_translation_by_angle)."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    na = t_a / (np.linalg.norm(t_a, axis=1, keepdims=True) + eps)
    nb = t_b / (np.linalg.norm(t_b, axis=1, keepdims=True) + eps)
    loss_t = np.clip(1.0 - np.sum(na * nb, axis=1) ** 2, eps, None)
    err = np.arccos(np.sqrt(np.clip(1 - loss_t, 0.0, 1.0)))
    deg = err * 180.0 / np.pi
    if ambiguity:
        deg = np.minimum(deg, np.abs(180 - deg))
    return deg


def se3_inverse_np(se3: np.ndarray) -> np.ndarray:
    r = se3[..., :3, :3]
    t = se3[..., :3, 3:]
    rt = np.swapaxes(r, -1, -2)
    out = np.tile(np.eye(4), se3.shape[:-2] + (1, 1))
    out[..., :3, :3] = rt
    out[..., :3, 3:] = -rt @ t
    return out


def camera_to_rel_deg(
    pred_w2c: np.ndarray, gt_w2c: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs relative rotation/translation angular errors in degrees.
    pred/gt: (N, 4, 4) world-to-camera (reference metric.py:107-151)."""
    n = pred_w2c.shape[0]
    i1, i2 = np.triu_indices(n, k=1)
    rel_pred = se3_inverse_np(pred_w2c[i1]) @ pred_w2c[i2]
    rel_gt = se3_inverse_np(gt_w2c[i1]) @ gt_w2c[i2]
    r_deg = rotation_angle_deg(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_deg = translation_angle_deg(rel_gt[:, :3, 3], rel_pred[:, :3, 3])
    return r_deg, t_deg


def calculate_auc(
    r_error: np.ndarray, t_error: np.ndarray, max_threshold: int = 30
) -> Tuple[float, np.ndarray]:
    """AUC of the max(r,t) error CDF over integer-degree bins (reference
    metric.py:154-182)."""
    max_errors = np.maximum(r_error, t_error)
    bins = np.arange(max_threshold + 1)
    hist, _ = np.histogram(max_errors, bins=bins)
    norm = hist.astype(float) / max(len(max_errors), 1)
    return float(np.mean(np.cumsum(norm))), norm


def camera_auc(
    pred_w2c: np.ndarray, gt_w2c: np.ndarray, thresholds=(3, 5, 10, 20, 30)
) -> dict:
    """AUC@k suite (the eval used in the reference training details,
    g2vlm.py:543-550)."""
    r_deg, t_deg = camera_to_rel_deg(pred_w2c, gt_w2c)
    return {
        f"auc@{th}": calculate_auc(r_deg, t_deg, th)[0] for th in thresholds
    }
