"""Parity of the port's ops (g2vlm_tpu_torch.ops, utils, data) with the JAX
package on the CPU in fp32, and of the plain versions of the two CUDA
kernels with the Pallas kernels they replace, run in interpret mode."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.data import device_preprocess as jdp
from g2vlm_tpu.ops import attention as jatt
from g2vlm_tpu.ops import flash_attention as jfa
from g2vlm_tpu.ops import masks as jmasks
from g2vlm_tpu.ops import norms as jnorms
from g2vlm_tpu.ops import rope as jrope
from g2vlm_tpu.utils import image as jimage
from g2vlm_tpu_torch.data import device_preprocess as tdp
from g2vlm_tpu_torch.ops import attention as tatt
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.ops import masks as tmasks
from g2vlm_tpu_torch.ops import norms as tnorms
from g2vlm_tpu_torch.ops import rope as trope
from g2vlm_tpu_torch.utils import image as timage
from g2vlm_tpu_torch.utils.geometry import homogenize_points

REPO = Path(__file__).resolve().parent.parent
# the kernel tests' tolerances (tests/test_flash_attention.py): fp32 sums in
# another order and block size
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
OP_TOL = dict(atol=1e-5, rtol=1e-5)
# F.interpolate computes its antialias taps in fp32; the JAX matrices are
# built in fp64 and rounded once
RESIZE_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tinfo(info):
    return tmasks.TokenInfo(*(_t(f) for f in info))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_norms_match_jax(rng, dtype):
    x = rng.standard_normal((5, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
        tol = dict(atol=2e-2, rtol=2e-2)  # one bf16 rounding of the output
    else:
        jx, tx = jnp.asarray(x), _t(x)
        tol = OP_TOL
    for got, want in (
        (tnorms.rms_norm(tx, _t(w), 1e-6), jnorms.rms_norm(jx, jnp.asarray(w), 1e-6)),
        (tnorms.layer_norm(tx, _t(w), _t(b), 1e-6), jnorms.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), 1e-6)),
    ):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_mrope_and_rotate_half_match_jax(rng):
    pos = rng.integers(0, 900, (3, 40))
    hd, section = 16, (2, 3, 3)
    np.testing.assert_array_equal(trope.mrope_axis_map(hd, section), jrope.mrope_axis_map(hd, section))
    tc, ts = trope.mrope_cos_sin(_t(pos), hd, 1e6, section)
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, section)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OP_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **OP_TOL)
    x = rng.standard_normal((4, 3, hd)).astype(np.float32)
    np.testing.assert_array_equal(trope.rotate_half(_t(x)).numpy(), np.asarray(jrope.rotate_half(jnp.asarray(x))))


@pytest.mark.parametrize("hd", [8, 96])
def test_rope2d_matches_jax(rng, hd):
    pos = rng.integers(0, 37, (2, 30, 2)).astype(np.int32)
    tc, ts = trope.rope2d_cos_sin(_t(pos), hd, 100.0)
    jc, js = jrope.rope2d_cos_sin(jnp.asarray(pos), hd, 100.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OP_TOL)
    x = rng.standard_normal((2, 30, 3, hd)).astype(np.float32)
    got = trope.apply_rope2d_bshd(_t(x), tc, ts)
    want = jrope.apply_rope2d_bshd(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def _info_case(case):
    return jmasks.make_token_info_np(case["sample_lens"], case["split_lens"], case["modes"], pad_to=case.get("pad_to"))


SEGMENT_CASES = [
    dict(sample_lens=[96], split_lens=[96], modes=["causal"]),
    dict(sample_lens=[100, 156], split_lens=[40, 60, 56, 100], modes=["causal", "full", "causal", "full"]),
    dict(sample_lens=[70, 130], split_lens=[30, 40, 50, 80], modes=["causal", "noise", "full", "noise"], pad_to=237),
]


def test_segment_mask_and_token_info_match_jax():
    for case in SEGMENT_CASES:
        jinfo = _info_case(case)
        tinfo = tmasks.make_token_info(case["sample_lens"], case["split_lens"], case["modes"], pad_to=case.get("pad_to"))
        for a, b in zip(tinfo, jinfo):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            tmasks.make_segment_mask(tinfo, tinfo).numpy(), np.asarray(jmasks.make_segment_mask(jinfo, jinfo))
        )
        packed = tinfo.packed()
        assert packed.shape == (tinfo.seq_len, 4) and packed.dtype == torch.int32


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("heads", [(4, 2), (3, 3)])
def test_segment_attention_forms_match_jax(rng, case, heads):
    """Dense and chunked plain forms (several KV chunks) against JAX's."""
    h, kvh = heads
    jinfo = _info_case(case)
    s = len(jinfo.doc_id)
    q = rng.standard_normal((s, h, 32)).astype(np.float32)
    k = rng.standard_normal((s, kvh, 32)).astype(np.float32)
    v = rng.standard_normal((s, kvh, 32)).astype(np.float32)
    want = np.asarray(jatt.segment_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jinfo, jinfo, impl="dense"))
    tinfo = _tinfo(jinfo)
    dense = tatt.segment_attention_dense(_t(q), _t(k), _t(v), tinfo, tinfo)
    chunked = tatt.segment_attention_chunked(_t(q), _t(k), _t(v), tinfo, tinfo, kv_chunk=64)
    np.testing.assert_allclose(dense.numpy(), want, **KERNEL_TOL)
    np.testing.assert_allclose(chunked.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_kernel_plain_version_matches_pallas(rng, case):
    """K2's plain version against the Pallas `_flash_kernel` (interpret)."""
    jinfo = _info_case(case)
    s = len(jinfo.doc_id)
    h, kvh, d = 4, 2, 64
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k = rng.standard_normal((s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((s, kvh, d)).astype(np.float32)
    want = jfa.flash_segment_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jinfo, jinfo,
        interpret=True, block_q=128, block_kv=128,
    )
    tinfo = _tinfo(jinfo)
    got = tfa.flash_segment_attention(_t(q), _t(k), _t(v), tinfo, tinfo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    if case.get("pad_to"):
        assert np.all(got.numpy()[sum(case["sample_lens"]):] == 0)


@pytest.mark.parametrize(
    "b,s,m,h,d,valid_kv,cross",
    [
        (2, 50, 50, 2, 64, None, False),
        (2, 45, 37, 3, 96, 30, False),  # ragged S != M, valid_kv cut
        (3, 29, 41, 2, 96, None, True),  # batch-1 frame-0 K/V
    ],
)
def test_batched_kernel_plain_version_matches_pallas(rng, b, s, m, h, d, valid_kv, cross):
    """K1's plain version against the Pallas `_batched_flash_kernel` (interpret)."""
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kb = 1 if cross else b
    k = rng.standard_normal((kb, m, h, d)).astype(np.float32)
    v = rng.standard_normal((kb, m, h, d)).astype(np.float32)
    jk = jnp.broadcast_to(jnp.asarray(k), (b, m, h, d))
    jv = jnp.broadcast_to(jnp.asarray(v), (b, m, h, d))
    want = jfa.flash_batched_attention(
        jnp.asarray(q), jk, jv, valid_kv=valid_kv, interpret=True, block_q=128, block_kv=128
    )
    tk, tv = _t(k).expand(b, m, h, d), _t(v).expand(b, m, h, d)
    got = tfa.flash_batched_attention(_t(q), tk, tv, valid_kv=valid_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing(rng):
    tfa.reset_launch_counts()
    q = _t(rng.standard_normal((1, 20, 2, 64)).astype(np.float32))
    tfa.flash_batched_attention(q, q, q)
    info = tmasks.make_token_info([20], [20], ["causal"])
    tfa.flash_segment_attention(q[0], q[0], q[0], info, info)
    assert set(tfa.launch_counts) >= {"flash_batched_attention", "flash_segment_attention"}
    assert not any(tfa.launch_counts.values())


@pytest.mark.parametrize(
    "shape,out_hw,method",
    [((3, 37, 37), (21, 37), "bicubic"), ((2, 3, 54, 76), (42, 56), "bilinear"), ((4, 20, 30), (20, 30), "bilinear")],
)
def test_resize_matches_jax(rng, shape, out_hw, method):
    x = rng.standard_normal(shape).astype(np.float32)
    got = timage.resize_hw(_t(x), out_hw, mode=method)
    want = jimage.resize_hw(jnp.asarray(x), out_hw, method=method, antialias=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RESIZE_TOL)


def test_device_preprocess_matches_jax(rng):
    frames = (rng.random((2, 54, 76, 3)) * 255).astype(np.uint8)
    assert tdp.target_hw(54, 76, 56, 14) == jdp.target_hw(54, 76, 56, 14)
    th, tw = tdp.target_hw(54, 76, 56, 14)
    got = tdp.preprocess_views_device(_t(frames), (th, tw))
    want = jdp.preprocess_views_device(jnp.asarray(frames), (th, tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RESIZE_TOL)


def test_homogenize_points(rng):
    p = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    from g2vlm_tpu.utils.geometry import homogenize_points as jh

    np.testing.assert_array_equal(homogenize_points(_t(p)).numpy(), np.asarray(jh(jnp.asarray(p))))


def test_port_never_imports_jax():
    """The machine with the card has no JAX: importing the port (and its
    pipeline) must leave no jax module loaded."""
    code = (
        "import sys\n"
        "import g2vlm_tpu_torch.inference.pipeline, g2vlm_tpu_torch.weights\n"
        "import g2vlm_tpu_torch.ops.flash_attention\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("case", SEGMENT_CASES[1:])
def test_block_codes_match_jax(case):
    """K2's SKIP/PARTIAL/FULL tile codes against `_block_codes`, at the
    kernel's 64-row tile."""
    jinfo = _info_case(case)
    tinfo = _tinfo(jinfo)
    qm = tinfo.packed()
    want = jfa._block_codes(
        jnp.pad(jnp.asarray(qm.numpy()), ((0, -len(qm) % 64), (0, 0)), constant_values=-2),
        jnp.pad(jnp.asarray(qm.numpy()), ((0, -len(qm) % 64), (0, 0)), constant_values=-1).T,
        64, 64,
    )
    got = tfa.block_codes(qm, qm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {0, 1, 2} >= set(np.unique(got.numpy()))
