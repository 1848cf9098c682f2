"""The port's evaluation tools against g2vlm_tpu on the CPU: the numpy
copies (metrics, rotation, alignment, synthetic scenes, depth loading),
the tensor geometry additions (within 1e-6), and `eval_points_torch.py` /
`eval_camera_torch.py` against `eval_points.py` / `eval_camera.py` (the
same printed numbers in the npz and self-check modes; finite scores from a
tiny model run)."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.data import recon_dataset as jrd
from g2vlm_tpu.data import synthetic as jsyn
from g2vlm_tpu.utils import alignment as jal
from g2vlm_tpu.utils import geometry as jgeo
from g2vlm_tpu.utils import metrics as jmet
from g2vlm_tpu.utils import rotation as jrot
from g2vlm_tpu_torch.data import recon_dataset as trd
from g2vlm_tpu_torch.data import synthetic as tsyn
from g2vlm_tpu_torch.utils import alignment as tal
from g2vlm_tpu_torch.utils import geometry as tgeo
from g2vlm_tpu_torch.utils import metrics as tmet
from g2vlm_tpu_torch.utils import rotation as trot

REPO = Path(__file__).resolve().parent.parent


def _poses(rng, n):
    """n random rigid camera-to-world (n, 4, 4) float64 poses."""
    q = rng.standard_normal((n, 4))
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = jrot.quaternion_to_matrix(q)
    out[:, :3, 3] = rng.standard_normal((n, 3))
    return out


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _copy_cases(rng):
    poses = _poses(rng, 5)
    pred = poses.copy()
    pred[:, :3, 3] += 0.1 * rng.standard_normal((5, 3))
    x = rng.standard_normal((2, 40)) + 2.0
    y = 1.7 * x + 0.3 + 0.05 * rng.standard_normal((2, 40))
    w = rng.random((2, 40))
    p_src = rng.standard_normal((2, 30, 3))
    p_tgt = 2.0 * p_src + np.asarray([0.0, 0.0, 0.5]) + 0.01 * rng.standard_normal((2, 30, 3))
    pw = rng.random((2, 30))
    err_r, err_t = rng.random(20) * 40, rng.random(20) * 40
    return {
        "matrix_to_quaternion": ("metrics", (poses[:, :3, :3],)),
        "rotation_angle_deg": ("metrics", (poses[:, :3, :3], pred[:, :3, :3])),
        "translation_angle_deg": ("metrics", (poses[:, :3, 3], pred[:, :3, 3])),
        "se3_inverse_np": ("metrics", (poses,)),
        "camera_to_rel_deg": ("metrics", (jmet.se3_inverse_np(pred), jmet.se3_inverse_np(poses))),
        "calculate_auc": ("metrics", (err_r, err_t, 30)),
        "camera_auc": ("metrics", (jmet.se3_inverse_np(pred), jmet.se3_inverse_np(poses))),
        "quaternion_to_matrix": ("rotation", (rng.standard_normal((6, 4)),)),
        "standardize_quaternion": ("rotation", (rng.standard_normal((6, 4)),)),
        "axis_angle_to_matrix": ("rotation", (rng.standard_normal((6, 3)),)),
        "matrix_to_axis_angle": ("rotation", (poses[:, :3, :3],)),
        "umeyama": ("rotation", (p_src[0], p_tgt[0])),
        "align": ("alignment", (x, y, w, 0.5)),
        "align_depth_scale": ("alignment", (x, y, w)),
        "align_points_scale": ("alignment", (p_src, p_tgt, pw)),
        "align_depth_affine": ("alignment", (x, y, w, 1.0)),
        "align_points_scale_z_shift": ("alignment", (p_src, p_tgt, pw)),
        "align_affine_lstsq": ("alignment", (x, y, w)),
        "align_depth_affine_irls": ("alignment", (x, y, w, 20)),
        "align_points_z_shift": ("alignment", (p_src, p_tgt, pw)),
        "align_points_xyz_shift": ("alignment", (p_src, p_tgt, pw)),
    }


_COPY_NAMES = sorted(_copy_cases(np.random.default_rng(0)))
_MODULES = {"metrics": (tmet, jmet), "rotation": (trot, jrot), "alignment": (tal, jal)}


@pytest.mark.parametrize("name", _COPY_NAMES)
def test_numpy_copies_equal_the_originals(name):
    module, args = _copy_cases(np.random.default_rng(0))[name]
    port, orig = _MODULES[module]
    _same(getattr(port, name)(*args), getattr(orig, name)(*args))


def test_synthetic_scene_and_depth_loading_equal_the_originals(tmp_path, rng):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tpath = tsyn.make_tiny_scene_jsonl(str(tmp_path / "t"), n_frames=3, seed=5)
    jpath = jsyn.make_tiny_scene_jsonl(str(tmp_path / "j"), n_frames=3, seed=5)
    tframes = json.loads(Path(tpath).read_text())["frames"]
    jframes = json.loads(Path(jpath).read_text())["frames"]
    assert len(tframes) == 3
    for tf, jf in zip(tframes, jframes):
        for key in ("image", "depth"):
            assert Path(tf[key]).name == Path(jf[key]).name
            assert Path(tf[key]).read_bytes() == Path(jf[key]).read_bytes()
        assert {k: v for k, v in tf.items() if k not in ("image", "depth")} == {
            k: v for k, v in jf.items() if k not in ("image", "depth")}
        depth = trd.load_depth(tf["depth"], tf["depth_scale"])
        _same(depth, jrd.load_depth(jf["depth"], jf["depth_scale"]))
        intr, extr = np.asarray(tf["intrinsics"], np.float32), np.asarray(tf["extrinsics"], np.float32)
        _same(trd.depth_to_world_points(depth, intr, extr), jrd.depth_to_world_points(depth, intr, extr))
    raw = rng.random((7, 9)).astype(np.float32) * 3
    raw[2, 3] = 0.0
    raw[4, 5] = np.nan
    np.save(tmp_path / "d.npy", raw)
    np.savez(tmp_path / "d.npz", depth=raw)
    for name in ("d.npy", "d.npz"):
        _same(trd.load_depth(str(tmp_path / name), 2.0), jrd.load_depth(str(tmp_path / name), 2.0))
    _same(trd.depth_to_world_points(raw, intr, extr), jrd.depth_to_world_points(raw, intr, extr))


@pytest.mark.parametrize("fn", ["transform_points", "depthmap_to_camera_coordinates",
                                "depthmap_to_world_coordinates", "points_to_normals"])
def test_geometry_additions_match_jax(rng, fn):
    depth = (rng.random((6, 7)) * 3).astype(np.float32)
    depth[1, 2] = 0.0
    intr = np.asarray([[50.0, 0, 3.5], [0, 40.0, 3.0], [0, 0, 1]], np.float32)
    c2w = _poses(rng, 2).astype(np.float32)
    pts = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    mask = rng.random((2, 6, 7)) > 0.2
    t, j = torch.from_numpy, jnp.asarray
    if fn == "transform_points":
        got, want = tgeo.transform_points(t(c2w), t(pts)), jgeo.transform_points(j(c2w), j(pts))
    elif fn == "depthmap_to_camera_coordinates":
        got, want = tgeo.depthmap_to_camera_coordinates(t(depth), t(intr)), jgeo.depthmap_to_camera_coordinates(
            j(depth), j(intr))
    elif fn == "depthmap_to_world_coordinates":
        got = tgeo.depthmap_to_world_coordinates(t(depth), t(intr), t(c2w[0]))
        want = jgeo.depthmap_to_world_coordinates(j(depth), j(intr), j(c2w[0]))
    else:
        got, want = tgeo.points_to_normals(t(pts), t(mask)), jgeo.points_to_normals(j(pts), j(mask))
        unmasked = tgeo.points_to_normals(t(pts))
        assert unmasked[1] is None and torch.equal(unmasked[0], got[0])
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert g.dtype == torch.bool if w.dtype == jnp.bool_ else g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def _run(script, *args):
    proc = subprocess.run([sys.executable, script, *args], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def npz_pair(tmp_path_factory):
    """A pseudo-GT cache and a prediction: points (4, 21, 37, 3) and camera
    poses (4, 4, 4), the prediction a scaled, noisy copy."""
    rng = np.random.default_rng(7)
    path = tmp_path_factory.mktemp("npz")
    gt_pts = rng.standard_normal((4, 21, 37, 3)).astype(np.float32)
    gt_poses = _poses(rng, 4)
    pred_poses = gt_poses.copy()
    pred_poses[:, :3, 3] += 0.05 * rng.standard_normal((4, 3))
    pred_poses[1:, :3, :3] = pred_poses[1:, :3, :3] @ jrot.axis_angle_to_matrix(0.05 * rng.standard_normal((3, 3)))
    np.savez(path / "ref.npz", points=gt_pts, camera_poses=gt_poses)
    np.savez(path / "pred.npz", points=(0.6 * gt_pts + 0.05 * rng.standard_normal(gt_pts.shape)).astype(np.float32),
             camera_poses=pred_poses)
    return str(path / "ref.npz"), str(path / "pred.npz")


@pytest.mark.parametrize("tool", ["eval_points", "eval_camera"])
def test_npz_mode_prints_what_the_jax_tool_prints(npz_pair, tool):
    ref, pred = npz_pair
    args = ["--pseudo_gt_npz", ref, "--pred_npz", pred]
    want = _run(f"{tool}.py", *args)
    got = _run(f"{tool}_torch.py", *args)
    assert got == want and len(got.splitlines()) >= 3


def test_camera_self_check_prints_what_the_jax_tool_prints():
    want = _run("eval_camera.py", "--self_check")
    got = _run("eval_camera_torch.py", "--self_check")
    assert got == want and got.rstrip().endswith("SELF-CHECK PASS")


@pytest.mark.parametrize("tool", ["eval_points_torch.py", "eval_camera_torch.py"])
def test_tiny_model_run_gives_finite_scores(tool):
    out = _run(tool, "--tiny", "--device", "cpu", "--dtype", "float32")
    assert "smoke mode" in out and "scenes=1" in out
    scores = [float(line.split(":")[1]) for line in out.splitlines() if line.startswith(("AUC@", "local-", "world-"))]
    assert len(scores) == (5 if "camera" in tool else 2) and all(math.isfinite(s) for s in scores)
