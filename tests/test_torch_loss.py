"""Every function of the port's train/loss.py and the geometry helpers it
uses against their JAX counterparts, on the CPU in fp32, inputs from numpy
seeds. Tolerance 1e-5 (fp32 reductions in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.train import loss as jl
from g2vlm_tpu.utils import geometry as jgeo
from g2vlm_tpu_torch.train import loss as tl
from g2vlm_tpu_torch.utils import geometry as tgeo

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(kw or TOL))


def _poses(rng, *lead):
    """Random rigid transforms (..., 4, 4)."""
    q, _ = np.linalg.qr(rng.standard_normal(lead + (3, 3)))
    q = q * np.sign(np.linalg.det(q))[..., None, None]
    out = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    out[..., :3, :3] = q
    out[..., :3, 3] = rng.standard_normal(lead + (3,))
    return out.astype(np.float32)


def _scene(rng, b=2, n=3, h=12, w=10):
    """Predictions and ground truth with positive depths and ~80% valid pixels."""
    pts = rng.standard_normal((b, n, h, w, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 1.0
    pred = pts + 0.1 * rng.standard_normal(pts.shape).astype(np.float32)
    mask = rng.random((b, n, h, w)) < 0.8
    return pred, pts, mask


def test_geometry_helpers_match_jax(rng):
    mat = _poses(rng, 2, 3)
    _close(tgeo.se3_inverse(_t(mat)), jgeo.se3_inverse(jnp.asarray(mat)))
    depth = rng.standard_normal((2, 3, 9, 11)).astype(np.float32) + 2.0
    depth[0, 0, 2, 3] = 0.0  # a division by zero: nan_to_num semantics
    got = tgeo.depth_edge(_t(depth), rtol=0.03)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgeo.depth_edge(jnp.asarray(depth), rtol=0.03)))
    assert got.any() and not got.all()


def test_small_helpers_match_jax(rng):
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    x[1, 2] = 0.0
    y = rng.standard_normal((4, 5, 3)).astype(np.float32)
    w = rng.random((4, 5)) < 0.6
    _close(tl.safe_norm(_t(x)), jl.safe_norm(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    tl.safe_norm(xt).sum().backward()
    assert torch.isfinite(xt.grad).all() and (xt.grad[1, 2] == 0).all()  # no 0/0 at the zero vector
    _close(tl.weighted_mean(_t(x[..., 0]), _t(w), dim=(-2, -1), keepdim=True),
           jl.weighted_mean(jnp.asarray(x[..., 0]), jnp.asarray(w), axis=(-2, -1), keepdims=True))
    _close(tl.weighted_mean(_t(x)), jl.weighted_mean(jnp.asarray(x)))
    err = np.abs(x[..., 0])
    _close(tl._smooth(_t(err), 0.5), jl._smooth(jnp.asarray(err), 0.5))
    _close(tl._smooth(_t(err), 0), jl._smooth(jnp.asarray(err), 0))
    _close(tl.angle_diff_vec3(_t(x), _t(y)), jl.angle_diff_vec3(jnp.asarray(x), jnp.asarray(y)))
    _close(tl.huber(_t(x), _t(y), 0.1), jl.huber(jnp.asarray(x), jnp.asarray(y), 0.1))
    r, r_gt = _poses(rng, 2, 3)[..., :3, :3], _poses(rng, 2, 3)[..., :3, :3]
    _close(tl.rotation_angle_error(_t(r), _t(r_gt)), jl.rotation_angle_error(jnp.asarray(r), jnp.asarray(r_gt)))


def test_scale_alignment_matches_jax(rng):
    x = rng.standard_normal((3, 200)).astype(np.float32)
    x[0, :5] = 0.0  # sign(0) == 0 entries
    y = (1.7 * x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    w = rng.random(x.shape).astype(np.float32)
    _close(tl.align_scale_l1(_t(x), _t(y), _t(w)), jl.align_scale_l1(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    # no index with a non-negative derivative: the last sorted ratio
    neg = -np.abs(w)
    _close(tl.align_scale_l1(_t(x), _t(y), _t(neg)), jl.align_scale_l1(jnp.asarray(x), jnp.asarray(y), jnp.asarray(neg)))
    src = rng.standard_normal((2, 50, 3)).astype(np.float32)
    tgt = (0.6 * src).astype(np.float32)
    wt = rng.random((2, 50)).astype(np.float32)
    got = tl.align_points_scale(_t(src), _t(tgt), _t(wt))
    _close(got, jl.align_points_scale(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(wt)))
    np.testing.assert_allclose(got.numpy(), 0.6, atol=1e-5)


def test_prepare_roe_matches_jax(rng):
    pred, _, mask = _scene(rng)
    mask[1] = False  # an empty batch element -> ones
    got = tl.prepare_roe(_t(pred), _t(mask), 64)
    want = jl.prepare_roe(jnp.asarray(pred), jnp.asarray(mask), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1] == 1).all()


def test_normal_loss_matches_jax(rng):
    pred, gt, mask = _scene(rng)  # random depths: nearly every pixel is a depth edge
    _close(tl.normal_loss(_t(pred), _t(gt), _t(mask)),
           jl.normal_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    # a smooth surface (no depth edges) against a tilted prediction: a loss well above 0, and its gradient
    ys, xs = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 10), indexing="ij")
    z = 3.0 + 0.02 * np.sin(2 * xs) + 0.02 * ys
    gt = np.broadcast_to(np.stack([xs * z, ys * z, z], -1), (2, 3, 12, 10, 3)).astype(np.float32)
    pred = (gt + 0.05 * rng.standard_normal(gt.shape)).astype(np.float32)
    want, wgrad = jax.value_and_grad(lambda p: jnp.sum(jl.normal_loss(p, jnp.asarray(gt), jnp.asarray(mask))))(
        jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    got = tl.normal_loss(tp, _t(gt), _t(mask)).sum()
    assert got.item() > 1e-3
    _close(got, want)
    got.backward()
    _close(tp.grad, wgrad, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("with_conf", [False, True])
def test_point_loss_matches_jax(rng, with_conf):
    pred_l, gt_l, mask = _scene(rng)
    pred_g, gt_g, _ = _scene(rng)
    pred = {"local_points": pred_l, "global_points": pred_g}
    gt = {"local_points": gt_l, "global_points": gt_g, "valid_masks": mask}
    nb = np.asarray([True, False])
    if with_conf:  # the conf / sky branch
        pred["conf"] = rng.standard_normal(mask.shape + (1,)).astype(np.float32)
        gt["conf_target_thresh"] = 0.05
        gt["sky_mask"] = rng.random(mask.shape) < 0.5
    tmap = lambda d: {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    jmap = lambda d: {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    got, gdet, gscale = tl.point_loss(tmap(pred), tmap(gt), _t(nb), local_align_res=128)
    want, wdet, wscale = jl.point_loss(jmap(pred), jmap(gt), jnp.asarray(nb), local_align_res=128)
    _close(got, want)
    _close(gscale, wscale)
    assert set(gdet) == set(wdet) and ("local_conf_loss" in gdet) == with_conf
    for key in wdet:
        _close(gdet[key], wdet[key])


def test_camera_loss_matches_jax(rng):
    pred, gt = _poses(rng, 2, 4), _poses(rng, 2, 4)
    scale = np.asarray([0.7, 1.3], np.float32)
    got, gdet = tl.camera_loss(_t(pred), _t(gt), _t(scale))
    want, wdet = jl.camera_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(scale))
    _close(got, want)
    for key in wdet:
        _close(gdet[key], wdet[key])
    one, _ = tl.camera_loss(_t(pred[:, :1]), _t(gt[:, :1]), _t(scale))  # a single view has no pairs
    assert one.item() == 0.0


def test_prepare_gt_and_normalize_pred_match_jax(rng):
    pred_l, world, mask = _scene(rng)
    mask[1] = False  # an empty batch element keeps norm_factor 1
    extr = _poses(rng, 2, 3)
    raw = {"world_points": world, "point_masks": mask, "extrinsics": extr}
    got = tl.prepare_gt({k: _t(v) for k, v in raw.items()})
    want = jl.prepare_gt({k: jnp.asarray(v) for k, v in raw.items()})
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], atol=2e-5, rtol=1e-5)
    mask[1] = rng.random(mask[1].shape) < 0.8
    pred = {"local_points": pred_l, "global_points": world, "camera_poses": extr}
    gotp = tl.normalize_pred({k: _t(v) for k, v in pred.items()}, _t(mask))
    wantp = jl.normalize_pred({k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(mask))
    for key in wantp:
        _close(gotp[key], wantp[key])


def test_pi3_loss_and_its_gradient_match_jax(rng):
    pred_l, world, mask = _scene(rng)
    pred = {"local_points": pred_l, "global_points": world + 0.1, "camera_poses": _poses(rng, 2, 3), "conf": None}
    raw = {"world_points": world, "point_masks": mask, "extrinsics": _poses(rng, 2, 3)}
    nb = np.asarray([True, True])

    def jloss(local, poses):
        p = {**{k: (None if v is None else jnp.asarray(v)) for k, v in pred.items()},
             "local_points": local, "camera_poses": poses}
        return jl.pi3_loss(p, {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(nb))

    (want, wdet), wgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred_l), jnp.asarray(pred["camera_poses"]))
    tp = {k: (None if v is None else _t(v)) for k, v in pred.items()}
    tp["local_points"].requires_grad_(True)
    tp["camera_poses"].requires_grad_(True)
    got, gdet = tl.pi3_loss(tp, {k: _t(v) for k, v in raw.items()}, _t(nb))
    _close(got, want)
    assert set(gdet) == set(wdet)
    for key in wdet:
        _close(gdet[key], wdet[key])
    got.backward()
    _close(tp["local_points"].grad, wgrads[0], atol=1e-6, rtol=1e-4)
    _close(tp["camera_poses"].grad, wgrads[1], atol=1e-5, rtol=1e-4)
