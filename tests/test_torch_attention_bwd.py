"""The plain lse forwards and plain backwards of the port's attention (the CPU
path of kernels K3, K5, K6, K7) against `jax.vjp` of the Pallas kernels in
interpret mode, the `autograd.Function`s' wiring against autograd through the
dense forms, `gradcheck` in fp64, and exact zeros for rows and keys that see
nothing. CPU, fp32, tiny shapes; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.ops import flash_attention as jfa
from g2vlm_tpu.ops import masks as jmasks
from g2vlm_tpu_torch.ops import attention as tatt
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.ops import masks as tmasks

# fp32 sums in another order and block size than the Pallas kernels
ATOL = 2e-5

SEGMENT_CASES = {
    "causal": dict(sample_lens=[96], split_lens=[96], modes=["causal"]),
    "full": dict(sample_lens=[80], split_lens=[80], modes=["full"], pad_to=100),
    "noise": dict(sample_lens=[70, 130], split_lens=[30, 40, 50, 80], modes=["causal", "noise", "full", "noise"],
                  pad_to=237),
    "mixed": dict(sample_lens=[100, 156], split_lens=[40, 60, 56, 100], modes=["causal", "full", "causal", "noise"],
                  pad_to=320),
}
# (b, s, m, h, d, valid_kv, cross): cross = batch-1 K/V expanded over the batch
BATCHED_CASES = {
    "self": (2, 50, 50, 2, 64, None, False),
    "valid_kv": (2, 45, 37, 3, 32, 30, False),
    "cross_m_ne_s": (3, 29, 41, 2, 32, None, False),
    "cross_frame0": (3, 29, 41, 2, 64, None, True),
}


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def _jinfo(case):
    return jmasks.make_token_info_np(case["sample_lens"], case["split_lens"], case["modes"], pad_to=case.get("pad_to"))


def _tinfo(jinfo):
    return tmasks.TokenInfo(*(_t(f) for f in jinfo))


def _segment_inputs(rng, s, h=4, kvh=2, d=32):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((s, h, d), (s, kvh, d), (s, kvh, d), (s, h, d)))


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_segment_plain_forward_and_backward_match_pallas_vjp(rng, name):
    """K3 + K5 plain versions against jax.vjp of `flash_segment_attention`."""
    jinfo = _jinfo(SEGMENT_CASES[name])
    s = len(jinfo.doc_id)
    q, k, v, co = _segment_inputs(rng, s)
    want_out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_segment_attention(q, k, v, jinfo, jinfo, block_q=128, block_kv=128, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(co))
    tinfo = _tinfo(jinfo)
    out, lse = tfa.flash_segment_attention_lse_reference(_t(q), _t(k), _t(v), tinfo, tinfo)
    assert lse.shape == (4, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    got = tfa.flash_segment_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(co), tinfo, tinfo, kv_chunk=64)
    for a, b, which in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=which)
    # lse is the log-sum-exp of the visible logits; LSE_EMPTY where none is
    mask = tmasks.make_segment_mask(tinfo, tinfo)
    logits = torch.einsum("qhd,khd->hqk", _t(q), _t(k).repeat_interleave(2, dim=1)) * 32 ** -0.5
    ref = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    seen = mask.any(-1)
    np.testing.assert_allclose(lse[:, seen].numpy(), ref[:, seen].numpy(), atol=ATOL)
    assert (lse[:, ~seen] == tfa.LSE_EMPTY).all()


@pytest.mark.parametrize("name", list(BATCHED_CASES))
def test_batched_plain_forward_and_backward_match_pallas_vjp(rng, name):
    """K6 + K7 plain versions against jax.vjp of `flash_batched_attention`."""
    b, s, m, h, d, valid_kv, cross = BATCHED_CASES[name]
    kb = 1 if cross else b
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((kb, m, h, d)).astype(np.float32)
    v = rng.standard_normal((kb, m, h, d)).astype(np.float32)
    co = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jf(q, k, v):
        k, v = (jnp.broadcast_to(t, (b, m, h, d)) for t in (k, v))
        return jfa.flash_batched_attention(q, k, v, valid_kv=valid_kv, block_q=128, block_kv=128, interpret=True)

    want_out, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(co))
    tk, tv = _t(k).expand(b, m, h, d), _t(v).expand(b, m, h, d)
    out, lse = tfa.flash_batched_attention_lse_reference(_t(q), tk, tv, valid_kv)
    assert lse.shape == (b, h, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    dq, dk, dv = tfa.flash_batched_attention_bwd_reference(_t(q), tk, tv, out, lse, _t(co), valid_kv)
    if cross:  # the dense (B, M, H, D) gradient sums over the batch, as expand's backward does
        dk, dv = dk.sum(0, keepdim=True), dv.sum(0, keepdim=True)
    for a, w, which in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL * (b if cross else 1), err_msg=which)
    if valid_kv is not None:
        assert (dk[:, valid_kv:] == 0).all() and (dv[:, valid_kv:] == 0).all()


@pytest.mark.parametrize("name", ["noise", "mixed"])
def test_segment_function_matches_autograd_through_dense(rng, name):
    """The autograd.Function behind `flash_segment_attention` (CPU: plain lse
    forward + plain backward) against autograd through the dense form."""
    tinfo = _tinfo(_jinfo(SEGMENT_CASES[name]))
    q, k, v, co = _segment_inputs(rng, tinfo.seq_len)
    leaves = [_t(x, grad=True) for x in (q, k, v)]
    out = tfa.flash_segment_attention(*leaves, tinfo, tinfo)
    assert out.grad_fn is not None and "SegmentAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad((torch.tanh(out) * _t(co)).sum(), leaves)
    ref_leaves = [_t(x, grad=True) for x in (q, k, v)]
    ref = tatt.segment_attention_dense(*ref_leaves, tinfo, tinfo)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL)
    want = torch.autograd.grad((torch.tanh(ref) * _t(co)).sum(), ref_leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    assert not any(tfa.launch_counts.values())


@pytest.mark.parametrize("name", ["valid_kv", "cross_frame0"])
def test_batched_function_matches_autograd_through_dense(rng, name):
    b, s, m, h, d, valid_kv, cross = BATCHED_CASES[name]
    kb = 1 if cross else b
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (kb, m, h, d), (kb, m, h, d))]
    co = _t(rng.standard_normal((b, s, h, d)).astype(np.float32))

    def run(fn):
        q, k, v = (_t(x, grad=True) for x in arrays)
        out = fn(q, k.expand(b, m, h, d), v.expand(b, m, h, d))
        return out, torch.autograd.grad((out * co).sum(), (q, k, v))

    out, got = run(lambda q, k, v: tfa.flash_batched_attention(q, k, v, valid_kv=valid_kv))
    assert "BatchedAttention" in type(out.grad_fn).__name__
    ref, want = run(lambda q, k, v: tfa.flash_batched_attention_reference(q, k, v, valid_kv=valid_kv))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL)
    for a, w in zip(got, want):  # the frame-0 K/V gradient is the sum over the batch
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL * b)


def test_functions_pass_gradcheck_in_fp64(rng):
    s, h, kvh, d = 16, 2, 1, 8
    info = tmasks.make_token_info([10, 4], [4, 6, 4], ["causal", "full", "noise"], pad_to=s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for shape in ((s, h, d), (s, kvh, d), (s, kvh, d)))
    assert torch.autograd.gradcheck(lambda q, k, v: tfa.flash_segment_attention(q, k, v, info, info), (q, k, v))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for shape in ((2, s, h, d), (1, 12, h, d), (1, 12, h, d)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_batched_attention(q, k.expand(2, -1, -1, -1), v.expand(2, -1, -1, -1), valid_kv=9),
        (q, k, v),
    )


def test_rows_and_keys_that_see_nothing_get_exact_zero(rng):
    """Pack padding (doc -1) sees no key and no query sees it: its out, dq,
    dk and dv rows are exactly 0, through the Function."""
    tinfo = _tinfo(_jinfo(SEGMENT_CASES["mixed"]))
    real = sum(SEGMENT_CASES["mixed"]["sample_lens"])
    q, k, v, co = _segment_inputs(rng, tinfo.seq_len)
    leaves = [_t(x, grad=True) for x in (q, k, v)]
    out = tfa.flash_segment_attention(*leaves, tinfo, tinfo)
    grads = torch.autograd.grad((out * _t(co)).sum(), leaves)
    assert (out[real:] == 0).all()
    for g in grads:
        assert torch.isfinite(g).all()
        assert (g[real:] == 0).all() and g[:real].abs().sum() > 0


def test_no_grad_path_is_the_plain_forward(rng):
    """Inputs that need no grad (and no_grad mode) do not build the Function."""
    q = _t(rng.standard_normal((1, 20, 2, 32)).astype(np.float32))
    assert tfa.flash_batched_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_batched_attention(qg, qg, qg).grad_fn is None
    assert tfa.flash_batched_attention(qg, qg, qg).grad_fn is not None
