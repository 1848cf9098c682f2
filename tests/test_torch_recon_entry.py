"""The recon entry path of the port against g2vlm_tpu on the CPU in fp32 at
tiny widths: `G2VLMPipeline.recon` on image paths, PIL images and arrays
(within tests/test_recon_e2e.py's end-to-end tolerances), the PLY export,
and `infer_recon_torch.py` against `infer_recon.py` on one checkpoint
directory (points within 1e-3 of max|ref|)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.utils import ply as jply
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.utils import ply as tply
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax
from torch_checkpoint import random_state_dict, write_checkpoint

REPO = Path(__file__).resolve().parent.parent
_TINY = tiny_test_config(visual_und=False)
CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
# tests/test_recon_e2e.py's end-to-end tolerances
TOLS = {"local_points": 2e-4, "camera_poses": 2e-4, "global_points": 2e-4, "points": 1e-3}


@pytest.fixture(scope="module")
def pipes():
    rng = np.random.default_rng(0)
    params = jg.init_params(CFG, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    for head in ("point_head", "global_point_head"):
        params[head]["proj"]["w"] = params[head]["proj"]["w"] * np.float32(0.1)  # exp(z) stays O(10)
    model = build_model(CFG, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    jpipe = JaxPipeline(jax.tree.map(jnp.asarray, params), CFG, new_token_ids=dict(TOKEN_IDS),
                        compute_dtype=jnp.float32)
    return jpipe, G2VLMPipeline(model, CFG, new_token_ids=dict(TOKEN_IDS))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("views")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 100, 3), dtype=np.uint8)).save(path / f"view_{i}.png")
    return path


def _inputs(image_dir, kind):
    paths = sorted(str(p) for p in image_dir.glob("*.png"))
    if kind == "paths":
        return paths
    pils = [Image.open(p).convert("RGB") for p in paths]
    return pils if kind == "pil" else [np.asarray(im) for im in pils]


@pytest.mark.parametrize("kind", ["paths", "pil", "arrays"])
def test_recon_matches_jax(pipes, image_dir, kind):
    jpipe, pipe = pipes
    images = _inputs(image_dir, kind)
    want = jpipe.recon(images, new_width=70)
    tfa.reset_launch_counts()
    got = pipe.recon(images, new_width=70)
    assert not any(tfa.launch_counts.values())  # the CPU path runs the plain versions
    assert set(got) == set(want) == set(TOLS) | {"images"}
    np.testing.assert_array_equal(got["images"], want["images"])
    assert got["images"].shape == (2, 3, 42, 70) and got["points"].shape == (2, 42, 70, 3)
    for key, atol in TOLS.items():
        assert isinstance(got[key], np.ndarray) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=atol, rtol=1e-3, err_msg=key)


def _read_ply(path):
    """-> (header lines, structured vertex array) of a binary PLY with xyz
    floats and optional uchar rgb."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    n = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
    fields = [("xyz", "<f4", 3)] + ([("rgb", "u1", 3)] if "property uchar red" in header else [])
    rec = np.frombuffer(raw[end:], dtype=fields)
    assert len(rec) == n and len(raw) == end + n * rec.dtype.itemsize
    return header, rec


def test_ply_export_matches_jax(pipes, image_dir, tmp_path, rng):
    """On recon outputs at image resolution (no upsample) the two files are
    byte-equal. On a point map at half resolution the upsample of the port
    (F.interpolate) and of JAX (interpolation matrices) round differently:
    headers, counts and colors are equal, the float fields agree within 1e-6.
    A non-finite point is a difference kept on purpose: the JAX matrices
    multiply it by the zero weights of every other pixel (0 x NaN = NaN), so
    its whole view is dropped; the port drops only the pixels whose
    interpolation support holds it, as F.interpolate does."""
    jpipe, _ = pipes
    pred = {k: np.asarray(v) for k, v in jpipe.recon(_inputs(image_dir, "paths"), new_width=70).items()}
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    stats = tply.save_ply_visualization(pred, str(a))
    assert stats == jply.save_ply_visualization(pred, str(b))
    assert a.read_bytes() == b.read_bytes()

    low = {"points": rng.standard_normal((2, 21, 35, 3)).astype(np.float32) * 3, "images": pred["images"]}
    stats, want_stats = tply.save_ply_visualization(low, str(a)), jply.save_ply_visualization(low, str(b))
    assert stats.keys() == want_stats.keys() and stats["written"] == want_stats["written"] == 2 * 42 * 70
    np.testing.assert_allclose(np.asarray(stats["bbox"]), np.asarray(want_stats["bbox"]), atol=1e-6, rtol=1e-6)
    (ha, ra), (hb, rb) = _read_ply(a), _read_ply(b)
    assert ha == hb
    np.testing.assert_array_equal(ra["rgb"], rb["rgb"])
    np.testing.assert_allclose(ra["xyz"], rb["xyz"], atol=1e-6, rtol=1e-6)

    low["points"][0, 3, 4, 1] = np.nan
    low["points"][1, 10, 20, 0] = np.inf
    stats, want_stats = tply.save_ply_visualization(low, str(a)), jply.save_ply_visualization(low, str(b))
    assert want_stats["invalid"] == 2 * 42 * 70
    assert 0 < stats["invalid"] <= 2 * 4 * 4 and stats["written"] == len(_read_ply(a)[1])
    tply.write_ply(str(a), low["points"][0, 0])
    jply.write_ply(str(b), low["points"][0, 0])
    assert a.read_bytes() == b.read_bytes()


def _run(script, *args, jax_cpu=False):
    env = dict(os.environ, JAX_PLATFORMS="cpu") if jax_cpu else None
    proc = subprocess.run([sys.executable, script, *args], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_infer_recon_torch_tiny_writes_a_ply(image_dir, tmp_path):
    out = tmp_path / "sub" / "tiny.ply"
    stdout = _run("infer_recon_torch.py", "--tiny", "--device", "cpu", "--image_folder", str(image_dir),
                  "--save_path", str(out), "--new_width", "70")
    assert "smoke mode" in stdout and "reconstructing 2 views" in stdout
    _, rec = _read_ply(out)
    assert len(rec) == 2 * 42 * 70 and np.isfinite(rec["xyz"]).all()


def test_infer_recon_torch_model_path_matches_jax(image_dir, tmp_path):
    """One checkpoint directory with its vocabulary: the port's CLI and the
    JAX package's write the same point cloud (fp32; within 1e-3 of max|ref|)."""
    ck = write_checkpoint(tmp_path / "ckpt", random_state_dict(), vocab=True)
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    common = ["--model_path", str(ck), "--image_folder", str(image_dir), "--dtype", "float32", "--new_width", "70"]
    port_out = _run("infer_recon_torch.py", *common, "--device", "cpu", "--save_path", str(a))
    _run("infer_recon.py", *common, "--save_path", str(b), jax_cpu=True)
    assert "smoke mode" not in port_out
    (ha, ra), (hb, rb) = _read_ply(a), _read_ply(b)
    assert ha == hb and len(ra) == 2 * 42 * 70
    np.testing.assert_array_equal(ra["rgb"], rb["rgb"])
    err = np.abs(ra["xyz"] - rb["xyz"]).max() / np.abs(rb["xyz"]).max()
    assert err < 1e-3, err
