"""The int8-QK attention of the port (K8) on the CPU: its quantiser against
the JAX package's, its plain version against the Pallas kernel it replaces
(run in interpret mode), and the selection rules around it. The pipelined
selection (K4) computes K2's function, so on the CPU it is the plain version
of K2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.ops import flash_attention as jfa
from g2vlm_tpu.ops import masks as jmasks
from g2vlm_tpu_torch.ops import attention as tatt
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.ops import masks as tmasks

# the three cases of tests/test_flash_attention.py::test_int8_qk_matches_dense
CASES = [
    dict(sample_lens=[256], split_lens=[256], modes=["causal"]),
    dict(sample_lens=[100, 156], split_lens=[40, 60, 56, 100], modes=["causal", "full", "causal", "full"]),
    dict(sample_lens=[256], split_lens=[256], modes=["causal"], outliers=True),
]
IDS = ["causal", "two_docs_mixed", "outliers"]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _inputs(rng, case, s=256, h=4, kvh=2, d=128, pad_to=None):
    q = rng.standard_normal((s, h, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((s, kvh, d)).astype(np.float32) * 0.3
    if case.get("outliers"):
        q[..., :4] *= 8
        k[..., :4] *= 8
        q[::37] *= 5
        k[::53] *= 5
    v = rng.standard_normal((s, kvh, d)).astype(np.float32)
    jinfo = jmasks.make_token_info_np(case["sample_lens"], case["split_lens"], case["modes"], pad_to=pad_to)
    tinfo = tmasks.make_token_info(case["sample_lens"], case["split_lens"], case["modes"], pad_to=pad_to)
    return q, k, v, jinfo, tinfo


def _jax_quantised(monkeypatch, q, k, v, jinfo, hadamard, kmean):
    """The q8, k8, kscale and folded q scale that `_flash_int8` hands to its
    Pallas kernel: the launch is intercepted, nothing of the package changes."""
    seen = {}

    def fake_pallas_call(kernel, out_shape, **kw):
        def run(codes, q8, k8, vp, kscale, qs_col, qm, km):
            seen.update(q8=np.asarray(q8), k8=np.asarray(k8), ks=np.asarray(kscale)[:, 0], qs_col=np.asarray(qs_col))
            return jnp.zeros(out_shape.shape, out_shape.dtype)

        return run

    monkeypatch.setattr(jfa.pl, "pallas_call", fake_pallas_call)
    monkeypatch.setenv("G2VLM_ATTN_INT8_HAD", "1" if hadamard else "0")
    monkeypatch.setenv("G2VLM_ATTN_INT8_KMEAN", "1" if kmean else "0")
    bq = 128
    jfa.flash_segment_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jinfo, jinfo,
                                block_q=bq, block_kv=bq, interpret=True, int8_qk=True)
    kvh, n_q, gbq, _ = seen["qs_col"].shape
    g = gbq // bq
    # undo the kernel-facing (kvh, n_q, g * block_q, 1) tiling of the q scales -> (H, S_q)
    seen["qs"] = seen["qs_col"].reshape(kvh, n_q, g, bq).transpose(0, 2, 1, 3).reshape(kvh * g, n_q * bq)
    return seen


@pytest.mark.parametrize("hadamard,kmean", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["had_kmean", "had", "kmean", "neither"])
def test_quantiser_equals_the_jax_quantiser(rng, monkeypatch, hadamard, kmean):
    """q8 / k8 bit for bit and the scales to fp32 rounding, padding keys
    included (they are outside the K mean)."""
    q, k, v, jinfo, tinfo = _inputs(rng, CASES[2], pad_to=256)
    k[200:] += 3.0  # a common-mode offset on some keys, so the K mean matters
    jinfo = jmasks.make_token_info_np([230], [230], ["causal"], pad_to=256)
    tinfo = tmasks.make_token_info([230], [230], ["causal"], pad_to=256)
    want = _jax_quantised(monkeypatch, q, k, v, jinfo, hadamard, kmean)
    q8, qs, k8, ks = tfa.quantize_qk(_t(q), _t(k), tinfo.packed(), None, hadamard, kmean)
    assert q8.dtype == torch.int8 and k8.dtype == torch.int8 and q8.shape == (256, 4, 128)
    # the port keeps rows first: (S, heads, D) against the JAX (heads, S, D)
    np.testing.assert_array_equal(q8.permute(1, 0, 2).numpy(), want["q8"])
    np.testing.assert_array_equal(k8.permute(1, 0, 2).numpy(), want["k8"])
    np.testing.assert_allclose(ks.numpy(), want["ks"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(qs.numpy(), want["qs"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_int8_attention_matches_the_interpreted_tpu_kernel(rng, case):
    q, k, v, jinfo, tinfo = _inputs(rng, case)
    want = np.asarray(jfa.flash_segment_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jinfo, jinfo,
        block_q=128, block_kv=128, interpret=True, int8_qk=True))
    tfa.reset_launch_counts()
    got = tfa.flash_segment_attention_int8(_t(q), _t(k), _t(v), tinfo, tinfo).numpy()
    assert not any(tfa.launch_counts.values())  # a CPU tensor takes the plain version
    # the same quantised operands; what differs is the softmax form (running
    # max here, shiftless exp2 there) and the order of fp32 sums
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    # and within the quantisation budget of the unquantised attention
    ref = tfa.flash_segment_attention_reference(_t(q), _t(k), _t(v), tinfo, tinfo).numpy()
    assert np.abs(got - ref).max() < 2e-2 * np.abs(ref).max()


def test_kmean_is_softmax_invariant_and_rescues_common_mode_keys(rng):
    s, h, kvh, d = 256, 2, 2, 128
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k = rng.standard_normal((s, kvh, d)).astype(np.float32) + 8.0 * rng.standard_normal((1, kvh, d)).astype(np.float32)
    v = rng.standard_normal((s, kvh, d)).astype(np.float32)
    info = tmasks.make_token_info([s], [128, 128], ["causal", "full"])
    ref = tfa.flash_segment_attention_reference(_t(q), _t(k), _t(v), info, info)
    shifted = tfa.flash_segment_attention_reference(_t(q), _t(k - k.mean(0, keepdims=True)), _t(v), info, info)
    np.testing.assert_allclose(shifted.numpy(), ref.numpy(), atol=5e-5, rtol=1e-4)

    def err(kmean):
        out = tfa.flash_segment_attention_int8(_t(q), _t(k), _t(v), info, info, kmean=kmean)
        return ((out - ref).abs().max() / ref.abs().max()).item()

    err_on, err_off = err(True), err(False)
    assert err_on < 2e-2 and err_on < err_off / 2, (err_on, err_off)


def test_int8_attention_has_no_gradient(rng):
    q, k, v, _, info = _inputs(rng, CASES[0], s=128, h=2, kvh=2)
    with pytest.raises(RuntimeError, match="no gradient"):
        tfa.flash_segment_attention_int8(_t(q[:128]).requires_grad_(True), _t(k[:128]), _t(v[:128]),
                                         info.slice(0, 128), info.slice(0, 128))
    with torch.no_grad():  # the same tensors without a grad context are served
        tfa.flash_segment_attention_int8(_t(q[:128]).requires_grad_(True), _t(k[:128]), _t(v[:128]),
                                         info.slice(0, 128), info.slice(0, 128))


def test_head_dim_80_pads_the_quantised_operands_to_96(rng):
    """The ViT's head dim is not a multiple of the s8 product's k = 32: q8 and
    k8 carry 16 zero channels, V and the output stay 80 wide, and no Hadamard
    rotation applies (80 is no power of two)."""
    s, h, d = 96, 4, 80
    q = rng.standard_normal((s, h, d)).astype(np.float32) * 3  # un-normed ViT logits: tens of nats
    k = rng.standard_normal((s, h, d)).astype(np.float32) * 3
    v = rng.standard_normal((s, h, d)).astype(np.float32)
    seg = torch.arange(3, dtype=torch.int32).repeat_interleave(32)
    info = tmasks.TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(s, dtype=torch.int32))
    q8, qs, k8, ks = tfa.quantize_qk(_t(q), _t(k), info.packed())
    assert q8.shape == (s, h, 96) and k8.shape == (s, h, 96)
    assert (q8[..., 80:] == 0).all() and (k8[..., 80:] == 0).all()
    assert qs.shape == (h, s) and ks.shape == (h, s)
    out = tfa.flash_segment_attention_int8(_t(q), _t(k), _t(v), info, info)
    assert out.shape == (s, h, d) and torch.isfinite(out).all()
    # exactly the attention of the dequantised operands (the K mean shifts a row's scores alike)
    scale = d ** -0.5
    qd = q8[..., :d].float() * (qs / (scale * tfa._LOG2E)).T[..., None]
    kd = k8[..., :d].float() * ks.T[..., None]
    deq = tfa.flash_segment_attention_reference(qd, kd, _t(v), info, info)
    np.testing.assert_allclose(out.numpy(), deq.numpy(), atol=2e-5, rtol=1e-4)
    # logits of ~10 nats make sharp softmaxes, which amplify the rounding of the scores
    ref = tfa.flash_segment_attention_reference(_t(q), _t(k), _t(v), info, info)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-1


def test_extreme_logits_stay_finite(rng):
    s, h, kvh, d = 128, 2, 2, 128
    v0 = rng.standard_normal(d).astype(np.float32)
    v0 /= np.linalg.norm(v0)
    q = np.tile(50.0 * v0, (s, h, 1)).astype(np.float32)
    k = np.tile(50.0 * v0, (s, kvh, 1)).astype(np.float32)
    v = rng.standard_normal((s, kvh, d)).astype(np.float32)
    info = tmasks.make_token_info([s], [s], ["full"])
    out = tfa.flash_segment_attention_int8(_t(q), _t(k), _t(v), info, info, kmean=False).numpy()
    assert np.isfinite(out).all()
    # equal enormous scores: a uniform softmax, the per-head mean of v
    np.testing.assert_allclose(out, np.broadcast_to(v.mean(0)[None], (s, kvh, d)), atol=1e-4, rtol=1e-4)


def test_segment_attention_dispatch_rules(rng, monkeypatch):
    """impl "int8" takes K8 only from 4096^2 query-key pairs on; below that,
    and for "auto", the segment kernel's wrapper; `pipelined` reaches it; an
    unknown impl raises."""
    q, k, v, _, info = _inputs(rng, CASES[1])
    calls = []
    monkeypatch.setattr(tfa, "flash_segment_attention_int8", lambda *a, **kw: calls.append("int8") or a[2])
    monkeypatch.setattr(tfa, "flash_segment_attention",
                        lambda *a, pipelined=False, **kw: calls.append(("segment", pipelined)) or a[2])
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert tatt.INT8_MIN_PAIRS == 4096 * 4096
    tatt.segment_attention(tq, tk, tv, info, info, impl="int8")
    tatt.segment_attention(tq, tk, tv, info, info, impl="auto", pipelined=True)
    monkeypatch.setattr(tatt, "INT8_MIN_PAIRS", 256 * 256)
    tatt.segment_attention(tq, tk, tv, info, info, impl="int8")
    assert calls == [("segment", False), ("segment", True), "int8"]
    with pytest.raises(ValueError):
        tatt.segment_attention(tq, tk, tv, info, info, impl="pallas")


def test_self_attender_equals_segment_attention_and_has_no_plan_on_the_cpu(rng):
    """The closure the layers of a forward share computes `segment_attention`;
    CPU metadata has no kernel plan (the plain versions read the TokenInfo)."""
    q, k, v, _, info = _inputs(rng, CASES[1])
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert tfa.segment_plan(info, info) is None
    for kw in (dict(impl="auto"), dict(impl="auto", pipelined=True), dict(impl="int8")):
        assert torch.equal(tatt.self_attender(info, **kw)(tq, tk, tv),
                           tatt.segment_attention(tq, tk, tv, info, info, **kw))


def test_pipelined_selection_on_the_cpu_equals_the_default(rng):
    q, k, v, _, info = _inputs(rng, CASES[1], pad_to=300, s=256)
    pad = np.zeros((44, 1, 1), np.float32)
    tq, tk, tv = (_t(np.concatenate([x, np.broadcast_to(pad, (44,) + x.shape[1:])])) for x in (q, k, v))
    base = tfa.flash_segment_attention(tq, tk, tv, info, info)
    assert torch.equal(tfa.flash_segment_attention(tq, tk, tv, info, info, pipelined=True), base)
    assert (base[256:] == 0).all()
    # with a gradient it is K3's function and K5's backward, again the same
    grads = []
    for pipelined in (False, True):
        qg = tq.clone().requires_grad_(True)
        tfa.flash_segment_attention(qg, tk, tv, info, info, pipelined=pipelined).square().sum().backward()
        grads.append(qg.grad)
    assert torch.equal(grads[0], grads[1])
