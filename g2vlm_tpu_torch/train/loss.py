"""Pi3 training losses (port of g2vlm_tpu/train/loss.py).

All reductions over the valid-pixel sets are masked sums with static shapes,
as in the JAX package; the ROE resampling and the weighted-L1 scale alignment
use sort / cumsum / gather. Everything runs in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..utils.geometry import depth_edge, homogenize_points, se3_inverse


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a NaN-free gradient at exactly-zero vectors (masked
    entries are exact zeros; d|x|/dx would be 0/0 there)."""
    sq = (x * x).sum(dim)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def weighted_mean(x, w=None, dim=None, keepdim: bool = False, eps: float = 1e-7):
    if w is None:
        return x.mean(dim=dim, keepdim=keepdim)
    w = w.to(x.dtype)
    return (x * w).mean(dim=dim, keepdim=keepdim) / (w.mean(dim=dim, keepdim=keepdim) + eps)


def _smooth(err: torch.Tensor, beta: float) -> torch.Tensor:
    """Huber-style smoothing."""
    if beta == 0:
        return err
    return torch.where(err < beta, 0.5 * err * err / beta, err - 0.5 * beta)


def angle_diff_vec3(v1, v2, eps: float = 1e-12):
    cross = safe_norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1)
    dot = (v1 * v2).sum(-1)
    return torch.atan2(cross + eps, dot)


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------

def align_scale_l1(x, y, w, eps: float = 1e-7):
    """argmin_a sum_i w_i |a x_i - y_i| over the last axis; returns a (...)."""
    sign = torch.sign(x)  # sign(0) == 0, as jnp.sign
    xs, ys = x * sign, y * sign
    ratio = ys / xs.clamp_min(eps)
    ratio_sorted, order = torch.sort(ratio, dim=-1, stable=True)
    wx = torch.gather(xs * w, -1, order)
    derivatives = 2 * torch.cumsum(wx, dim=-1) - wx.sum(-1, keepdim=True)
    # first index where the derivative is >= 0 (argmax of an int cast: the
    # first maximum), the last index when there is none
    nonneg = derivatives >= 0
    idx = torch.argmax(nonneg.to(torch.int8), dim=-1)
    idx = torch.where(nonneg.any(-1), idx, torch.full_like(idx, derivatives.shape[-1] - 1))
    return torch.gather(ratio_sorted, -1, idx[..., None])[..., 0]


def align_points_scale(points_src, points_tgt, weight):
    """(..., N, 3) x2 + (..., N) -> scale (...)."""
    w3 = weight[..., None].expand(points_src.shape)
    return align_scale_l1(points_src.flatten(-2), points_tgt.flatten(-2), w3.flatten(-2))


def prepare_roe(pts, mask, target_size: int = 4096):
    """Nearest-resample each batch's valid points to a fixed count.
    pts (B, N, H, W, C), mask (B, N, H, W) -> (B, target_size, C)."""
    b, c = pts.shape[0], pts.shape[-1]
    flat_pts = pts.reshape(b, -1, c)
    flat_mask = mask.reshape(b, -1)
    # stable-sort valid points to the front, preserving scan order
    order = torch.sort((~flat_mask).to(torch.int8), dim=-1, stable=True).indices
    gathered = torch.gather(flat_pts, 1, order[..., None].expand(-1, -1, c))
    n_valid = flat_mask.sum(-1)  # (B,)
    # nearest interpolation: out[i] = src[floor(i * n / target)]
    i = torch.arange(target_size, device=pts.device)
    idx = torch.floor(i[None, :] * (n_valid[:, None].to(torch.float32) / target_size)).to(torch.int64)
    idx = torch.minimum(idx.clamp_min(0), (n_valid[:, None] - 1).clamp_min(0))
    out = torch.gather(gathered, 1, idx[..., None].expand(-1, -1, c))
    # empty batches -> ones
    return torch.where((n_valid > 0)[:, None, None], out, torch.ones_like(out))


# ---------------------------------------------------------------------------
# point / normal losses
# ---------------------------------------------------------------------------

def normal_loss(points, gt_points, mask):
    """Cross-product angular loss over 2x2 neighborhoods. points (B,N,H,W,3)
    -> per-batch (B,)."""
    mask = mask & ~depth_edge(gt_points[..., 2], rtol=0.03)

    def corners(p):
        return p[..., :-1, :-1, :], p[..., :-1, 1:, :], p[..., 1:, :-1, :], p[..., 1:, 1:, :]

    lu, ru, ld, rd = corners(points)
    glu, gru, gld, grd = corners(gt_points)
    mlu, mru, mld, mrd = (m[..., 0] for m in corners(mask[..., None]))

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    pairs = [
        (cross(ru - rd, ld - rd), cross(gru - grd, gld - grd), mru & mld & mrd),
        (cross(lu - ru, rd - ru), cross(glu - gru, grd - gru), mlu & mrd & mru),
        (cross(ld - lu, ru - lu), cross(gld - glu, gru - glu), mld & mru & mlu),
        (cross(rd - ld, lu - ld), cross(grd - gld, glu - gld), mrd & mlu & mld),
    ]
    min_a, max_a, beta = math.radians(1), math.radians(90), math.radians(3)
    loss = 0.0
    for v, gv, m in pairs:
        ang = angle_diff_vec3(v, gv).clamp(min_a, max_a)
        loss = loss + m * _smooth(ang, beta)
    h, w = points.shape[-3], points.shape[-2]
    return loss.mean(dim=(1, 2, 3)) / (4 * max(h, w))


def point_loss(
    pred: Dict,
    gt: Dict,
    normal_batch_mask: Optional[torch.Tensor] = None,
    local_align_res: int = 4096,
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Scale-invariant local+global point loss. Returns (loss, details,
    per-batch scale). The scale alignment sees no gradient."""
    pred_local = pred["local_points"].float()
    gt_local = gt["local_points"].float()
    masks = gt["valid_masks"]

    z = gt_local[..., 2]
    z_floor = 0.1 * weighted_mean(z, masks, dim=(-2, -1), keepdim=True)
    weights = 1.0 / (torch.maximum(z, z_floor) + 1e-6)

    with torch.no_grad():
        xyz_pred = prepare_roe(pred_local, masks, local_align_res)
        xyz_gt = prepare_roe(gt_local, masks, local_align_res)
        xyz_w = prepare_roe(weights[..., None], masks, local_align_res)[..., 0]
        scale = align_points_scale(xyz_pred, xyz_gt, xyz_w).abs()  # flip non-positive solutions

    aligned = scale[:, None, None, None, None] * pred_local

    mw = masks.float()
    denom = 3.0 * mw.sum() + 1e-12
    l1 = (aligned - gt_local).abs() * weights[..., None]
    local_pts_loss = (l1 * mw[..., None]).sum() / denom

    details = {"local_pts_loss": local_pts_loss}
    loss = local_pts_loss

    nl_per_batch = normal_loss(aligned, gt_local, masks)  # (B,)
    if normal_batch_mask is None:
        nl = nl_per_batch.mean()
    else:
        nb = normal_batch_mask.float()
        nl = (nl_per_batch * nb).sum() / nb.sum().clamp_min(1.0)
    loss = loss + nl
    details["normal_loss"] = nl

    if pred.get("global_points") is not None:
        pred_global = pred["global_points"].float() * scale[:, None, None, None, None]
        g_l1 = (pred_global - gt["global_points"].float()).abs() * weights[..., None]
        global_pts_loss = (g_l1 * mw[..., None]).sum() / denom
        loss = loss + global_pts_loss
        details["global_pts_loss"] = global_pts_loss

    if pred.get("conf") is not None and "conf_target_thresh" in gt:
        # BCE confidence loss; the sky term needs a sky mask in gt["sky_mask"]
        conf = pred["conf"][..., 0].float()
        per_px = l1.sum(-1) / 3.0
        target = (per_px < gt["conf_target_thresh"]).float()
        softplus = torch.log1p(torch.exp(-conf.abs()))
        bce = conf.clamp_min(0) - conf * target + softplus
        conf_loss = (bce * mw).sum() / (mw.sum() + 1e-12)
        if "sky_mask" in gt:
            sw = (gt["sky_mask"] & ~masks).float()
            conf_loss = conf_loss + ((conf.clamp_min(0) + softplus) * sw).sum() / sw.sum().clamp_min(1.0)
        loss = loss + 0.05 * conf_loss
        details["local_conf_loss"] = conf_loss

    return loss, details, scale


# ---------------------------------------------------------------------------
# camera loss
# ---------------------------------------------------------------------------

def rotation_angle_error(r, r_gt, eps: float = 1e-6):
    residual = r.transpose(-1, -2) @ r_gt
    trace = torch.diagonal(residual, dim1=-2, dim2=-1).sum(-1)
    return torch.acos(((trace - 1) / 2).clamp(-1.0 + eps, 1.0 - eps))


def huber(x, y, delta: float):
    """Element-wise Huber loss (no delta normalization)."""
    d = (x - y).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def _scale_translation(poses: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """poses (B, N, 4, 4) with the translation column multiplied by factor (B,)."""
    mult = torch.ones_like(poses)
    mult[..., :3, 3] = factor[:, None, None]
    return poses * mult


def camera_loss(pred_poses, gt_poses, scale, alpha: float = 100.0):
    """All-pairs relative pose loss. pred/gt (B, N, 4, 4), scale (B,)."""
    b, n = pred_poses.shape[:2]
    pred = _scale_translation(pred_poses.float(), scale)
    gt = gt_poses.float()

    pred_rel = torch.einsum("bnij,bmjk->bnmik", se3_inverse(pred), pred)
    gt_rel = torch.einsum("bnij,bmjk->bnmik", se3_inverse(gt), gt)

    m = (~torch.eye(n, dtype=torch.bool, device=pred.device))[None].float()
    cnt = max(b * n * (n - 1), 1)  # n == 1 has no pairs -> zero loss

    t_err = huber(pred_rel[..., :3, 3], gt_rel[..., :3, 3], delta=0.1)
    trans_loss = (t_err * m[..., None]).sum() / (cnt * 3)

    r_err = rotation_angle_error(pred_rel[..., :3, :3], gt_rel[..., :3, :3])
    rot_loss = (r_err * m).sum() / cnt

    return alpha * trans_loss + rot_loss, {"trans_loss": trans_loss, "rot_loss": rot_loss}


# ---------------------------------------------------------------------------
# Pi3Loss
# ---------------------------------------------------------------------------

def _mean_valid_distance(points: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """Per-batch mean distance of the valid points (B,)."""
    dist = safe_norm(points * mw[..., None], dim=-1)
    return dist.sum(dim=(1, 2, 3)) / (mw.sum(dim=(1, 2, 3)) + 1e-8)


def prepare_gt(gt_raw: Dict) -> Dict:
    """World-frame GT -> first-camera frame + unit mean distance."""
    gt_pts = gt_raw["world_points"].float()
    masks = gt_raw["point_masks"]
    poses = gt_raw["extrinsics"].float()

    w2c0 = se3_inverse(poses[:, 0])
    gt_pts = torch.einsum("bij,bnhwj->bnhwi", w2c0, homogenize_points(gt_pts))[..., :3]
    poses = torch.einsum("bij,bnjk->bnik", w2c0, poses)

    mw = masks.float()
    norm_factor = _mean_valid_distance(gt_pts, mw)
    valid_batch = mw.sum(dim=(1, 2, 3)) > 0
    norm_factor = torch.where(valid_batch, norm_factor, torch.ones_like(norm_factor))
    gt_pts = gt_pts / norm_factor[:, None, None, None, None]
    poses = _scale_translation(poses, 1.0 / norm_factor)

    extr = se3_inverse(poses)
    gt_local = torch.einsum("bnij,bnhwj->bnhwi", extr, homogenize_points(gt_pts))[..., :3]
    return dict(global_points=gt_pts, local_points=gt_local, valid_masks=masks, camera_poses=poses)


def normalize_pred(pred: Dict, masks: torch.Tensor) -> Dict:
    """Scale predictions to unit mean valid-point distance."""
    local = pred["local_points"].float()
    norm_factor = _mean_valid_distance(local, masks.float())
    nf = norm_factor[:, None, None, None, None]
    out = dict(pred)
    out["local_points"] = local / nf
    if pred.get("global_points") is not None:
        out["global_points"] = pred["global_points"].float() / nf
    out["camera_poses"] = _scale_translation(pred["camera_poses"].float(), 1.0 / norm_factor)
    return out


def pi3_loss(
    pred: Dict,
    gt_raw: Dict,
    normal_batch_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full loss: point + 0.2 * camera."""
    gt = prepare_gt(gt_raw)
    for k in ("conf_target_thresh", "sky_mask"):  # conf supervision extras pass straight through
        if k in gt_raw:
            gt[k] = gt_raw[k]
    pred = normalize_pred(pred, gt["valid_masks"])

    p_loss, details, scale = point_loss(pred, gt, normal_batch_mask)
    c_loss, c_details = camera_loss(pred["camera_poses"], gt["camera_poses"], scale)
    details.update(c_details)
    return p_loss + 0.2 * c_loss, details
