"""Weighted truncated-L1 alignment solver family (MoGe-style): the port's own
copy of g2vlm_tpu/utils/alignment.py (numpy), which it does not import.

Behavioral spec: reference modeling/pi3/utils/alignment.py:52-499. These are
evaluation/offline utilities (only align_points_scale is on the training hot
path — its tensor form lives in train/loss.py); here they are exact numpy
solvers with the same minimizers:

  * align: argmin_a sum_i min(w_i |a x_i - y_i|, trunc) — exact via the
    candidate set {y_i/x_i} (the optimum of a piecewise-linear objective lies
    on a breakpoint, which is also how the reference searches).
  * anchored affine variants: best anchor by exhaustive scan, then the
    two-point reproduction the reference uses for a short autodiff graph.
  * IRLS variants and the weighted least-squares affine fit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def _align_candidates(x, y, w, trunc, eps=1e-7, chunk=256):
    """x,y,w (B, N). Returns (a, loss, index)."""
    sign = np.sign(x)
    xs, ys = x * sign, y * sign
    cand = ys / np.maximum(xs, eps)  # (B, N) candidate scales
    b, n = x.shape
    best_loss = np.full(b, np.inf)
    best_idx = np.zeros(b, np.int64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        a = cand[:, lo:hi]  # (B, C)
        res = np.abs(a[:, :, None] * xs[:, None, :] - ys[:, None, :]) * w[:, None, :]
        if trunc is not None:
            res = np.minimum(res, trunc)
        loss = res.sum(-1)  # (B, C)
        idx = np.argmin(loss, axis=1)
        lv = loss[np.arange(b), idx]
        better = lv < best_loss
        best_loss = np.where(better, lv, best_loss)
        best_idx = np.where(better, idx + lo, best_idx)
    a = cand[np.arange(b), best_idx]
    return a, best_loss, best_idx


def align(x, y, w, trunc: Optional[float] = None, eps: float = 1e-7):
    """Reference align (alignment.py:52-146). Shapes (..., N)."""
    x, y, w = np.broadcast_arrays(x, y, w)
    shape = x.shape[:-1]
    n = x.shape[-1]
    xf = x.reshape(-1, n).astype(np.float64)
    yf = y.reshape(-1, n).astype(np.float64)
    wf = w.reshape(-1, n).astype(np.float64)
    a, loss, idx = _align_candidates(xf, yf, wf, trunc, eps)
    return a.reshape(shape), loss.reshape(shape), idx.reshape(shape)


def align_depth_scale(depth_src, depth_tgt, weight, trunc=None):
    return align(depth_src, depth_tgt, weight, trunc)[0]


def align_points_scale(points_src, points_tgt, weight, trunc=None):
    w3 = np.broadcast_to(weight[..., None], points_src.shape)
    return align(
        points_src.reshape(*points_src.shape[:-2], -1),
        points_tgt.reshape(*points_tgt.shape[:-2], -1),
        w3.reshape(*w3.shape[:-2], -1),
        trunc,
    )[0]


def align_depth_affine(depth_src, depth_tgt, weight, trunc=None):
    """Anchored scale+shift (reference :163-214). Shapes (..., N)."""
    shape = depth_src.shape[:-1]
    n = depth_src.shape[-1]
    xs = depth_src.reshape(-1, n).astype(np.float64)
    ys = depth_tgt.reshape(-1, n).astype(np.float64)
    ws = weight.reshape(-1, n).astype(np.float64)
    b = xs.shape[0]
    scale = np.zeros(b)
    shift = np.zeros(b)
    for bi in range(b):
        anchors = np.nonzero(ws[bi] > 0)[0]
        if len(anchors) == 0:
            continue
        xa = xs[bi][None, :] - xs[bi][anchors][:, None]  # (A, N)
        ya = ys[bi][None, :] - ys[bi][anchors][:, None]
        wa = np.broadcast_to(ws[bi][None, :], xa.shape)
        a, loss, idx = _align_candidates(xa, ya, wa, trunc)
        best = np.argmin(loss)
        i1 = anchors[best]
        i2 = idx[best]
        s1, s2 = xs[bi][i1], xs[bi][i2]
        t1, t2 = ys[bi][i1], ys[bi][i2]
        sc = (t2 - t1) / ((s2 - s1) if s2 != s1 else 1e-7)
        scale[bi] = sc
        shift[bi] = t1 - sc * s1
    return scale.reshape(shape), shift.reshape(shape)


def align_points_scale_z_shift(points_src, points_tgt, weight, trunc=None):
    """Shared xyz scale + z shift via z-anchoring (reference :251-303)."""
    shape = points_src.shape[:-2]
    n = points_src.shape[-2]
    ps = points_src.reshape(-1, n, 3).astype(np.float64)
    pt = points_tgt.reshape(-1, n, 3).astype(np.float64)
    ws = weight.reshape(-1, n).astype(np.float64)
    b = ps.shape[0]
    scale = np.zeros(b)
    shift = np.zeros((b, 3))
    for bi in range(b):
        anchors = np.nonzero(ws[bi] > 0)[0]
        if len(anchors) == 0:
            continue
        best_loss, best = np.inf, None
        for ai in anchors:
            src_a = ps[bi].copy()
            tgt_a = pt[bi].copy()
            src_a[:, 2] -= ps[bi, ai, 2]
            tgt_a[:, 2] -= pt[bi, ai, 2]
            w3 = np.repeat(ws[bi], 3)
            a, loss, idx = _align_candidates(
                src_a.reshape(1, -1), tgt_a.reshape(1, -1), w3[None], trunc
            )
            if loss[0] < best_loss:
                best_loss = loss[0]
                best = (ai, idx[0], a[0])
        ai, _, sc = best
        scale[bi] = sc
        shift[bi] = [0.0, 0.0, pt[bi, ai, 2] - sc * ps[bi, ai, 2]]
    return scale.reshape(shape), shift.reshape(*shape, 3)


def align_affine_lstsq(x, y, w=None) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted least-squares a,b for y ~ a x + b (reference :399-417)."""
    if w is None:
        w = np.ones_like(x)
    w = w.astype(np.float64)
    xf = x.astype(np.float64)
    yf = y.astype(np.float64)
    sw = w.sum(-1)
    swx = (w * xf).sum(-1)
    swy = (w * yf).sum(-1)
    swxx = (w * xf * xf).sum(-1)
    swxy = (w * xf * yf).sum(-1)
    det = sw * swxx - swx ** 2
    a = (sw * swxy - swx * swy) / np.maximum(np.abs(det), 1e-12) * np.sign(det)
    b = (swy - a * swx) / np.maximum(sw, 1e-12)
    return a, b


def align_depth_affine_irls(depth_src, depth_tgt, weight, max_iter: int = 100, eps: float = 1e-12):
    """IRLS L1 scale+shift (reference :216-231)."""
    x = np.stack([depth_src, np.ones_like(depth_src)], axis=-1).astype(np.float64)
    y = depth_tgt.astype(np.float64)
    w = weight.astype(np.float64).copy()
    beta = None
    for _ in range(max_iter):
        xtw = x.swapaxes(-1, -2) * w[..., None, :]
        lhs = xtw @ x
        rhs = (xtw @ y[..., None])[..., 0]
        beta = np.linalg.solve(lhs + 1e-12 * np.eye(2), rhs[..., None])[..., 0]
        resid = np.abs(y - (x @ beta[..., None])[..., 0])
        w = weight / np.maximum(resid, eps)
    return beta[..., 0], beta[..., 1]


def align_points_z_shift(points_src, points_tgt, weight, trunc=None, max_iters: int = 30, eps: float = 1e-6):
    """Weighted-median z-shift (reference :358-377 solves the L1 shift)."""
    z_res = (points_tgt[..., 2] - points_src[..., 2])
    order = np.argsort(z_res, axis=-1)
    zs = np.take_along_axis(z_res, order, axis=-1)
    ws = np.take_along_axis(np.broadcast_to(weight, z_res.shape), order, axis=-1)
    cw = np.cumsum(ws, axis=-1)
    half = cw[..., -1:] / 2
    idx = np.argmax(cw >= half, axis=-1)
    shift_z = np.take_along_axis(zs, idx[..., None], axis=-1)[..., 0]
    shift = np.zeros(points_src.shape[:-2] + (3,))
    shift[..., 2] = shift_z
    return shift


def align_points_xyz_shift(points_src, points_tgt, weight, trunc=None, max_iters: int = 30, eps: float = 1e-6):
    """Per-axis weighted-median shift (reference :379-397)."""
    shifts = []
    for axis in range(3):
        res = points_tgt[..., axis] - points_src[..., axis]
        order = np.argsort(res, axis=-1)
        rs = np.take_along_axis(res, order, axis=-1)
        ws = np.take_along_axis(np.broadcast_to(weight, res.shape), order, axis=-1)
        cw = np.cumsum(ws, axis=-1)
        half = cw[..., -1:] / 2
        idx = np.argmax(cw >= half, axis=-1)
        shifts.append(np.take_along_axis(rs, idx[..., None], axis=-1)[..., 0])
    return np.stack(shifts, axis=-1)
