"""Parity of the port's KV-cache decoding (g2vlm_tpu_torch.inference.decoding)
with g2vlm_tpu.inference.decoding on the CPU in fp32 at tiny widths: the cache
fill and its int8 form, one decode step, the greedy loops, and the
teacher-forced extension."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.inference import decoding as jdec
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu_torch.inference import decoding as tdec
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

CFG = tiny_test_config(visual_und=False)
LLM = CFG.llm
EOS = 8
F32 = dict(compute_dtype=jnp.float32)
TOKS = [5, 12, 7, 30, 9, 21, 44, 3, 17, 26, 2]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    params = jg.init_params(CFG, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    model = build_model(CFG, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return jax.tree.map(jnp.asarray, params), model


def _prefills(toks, pad_to=16):
    out = []
    for mod in (jg, tg):
        b = mod.SequenceBuilder(11, 12)
        b.add_text(toks)
        out.append(b.build(pad_to=pad_to))
    return out


def _prefill_kv(models, toks=TOKS, pad_to=16):
    """The text-only prefill's per-layer K/V of both packages."""
    params, model = models
    jpre, tpre = _prefills(toks, pad_to)
    _, jkv = jg.prefill_hidden(params, jpre, None, CFG, compute_dtype=jnp.float32, attn_impl="dense", return_kv=True)
    with torch.inference_mode():
        _, tkv = tg.prefill_hidden(model, tpre, None, CFG, return_kv=True)
    return jpre, jkv, tpre, tkv


def _caches(models, quantized, capacity=32, **kw):
    jpre, jkv, tpre, tkv = _prefill_kv(models, **kw)
    jc = jdec.build_cache(jkv, jnp.asarray(jpre.seq_len, jnp.int32), LLM, capacity, dtype=jnp.float32,
                          quantized=quantized)
    tc = tdec.build_cache(list(tkv), tpre.seq_len, LLM, capacity, dtype=torch.float32, quantized=quantized)
    return jpre, jc, tc


def _assert_cache_equal(tc, jc, rows, tol):
    assert int(tc.length) == int(jc.length)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(tc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = a.numpy()[:, :, :rows], np.asarray(b)[:, :, :rows]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.int8:
            # a value on a rounding boundary may land on either side: fp32 sums upstream differ in order
            assert np.abs(a.astype(np.int32) - b).max() <= 1 and (a != b).mean() < 2e-3, name
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **tol)


def test_quant_equals_jax_bit_for_bit(rng):
    x = rng.standard_normal((7, 5, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero row takes the scale floor
    q, s = tdec._quant(torch.from_numpy(x))
    jq, js = jdec._quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (7, 5, 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_make_cache_layout_matches_jax():
    for quantized in (False, True):
        tc = tdec.make_cache(LLM, 24, torch.float32, quantized, device="cpu")
        jc = jdec.make_cache(LLM, 24, jnp.float32, quantized)
        for a, b in zip(tc, jc):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape)
        assert tc.k.dtype == (torch.int8 if quantized else torch.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        tdec.make_cache(LLM, 8)  # the default device is the card


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_fill_cache_matches_jax(models, quantized):
    jpre, jkv, tpre, tkv = _prefill_kv(models)
    for a, (jk, jv) in zip(tkv, zip(np.asarray(jkv["k"]), np.asarray(jkv["v"]))):
        np.testing.assert_allclose(a.k.numpy(), jk, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a.v.numpy(), jv, atol=1e-4, rtol=1e-4)
    jc = jdec.fill_cache(jdec.make_cache(LLM, 32, jnp.float32, quantized), jkv, jpre.seq_len)
    tc = tdec.fill_cache(tdec.make_cache(LLM, 32, torch.float32, quantized, device="cpu"), tkv, tpre.seq_len)
    _assert_cache_equal(tc, jc, rows=16, tol=dict(atol=1e-4, rtol=1e-4))
    # build_cache is the same fill on a fresh cache, and consumes its list
    kvs = list(tkv)
    built = tdec.build_cache(kvs, tpre.seq_len, LLM, 32, dtype=torch.float32, quantized=quantized)
    assert all(kv is None for kv in kvs)
    for a, b in zip(built, tc):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_decode_step_matches_jax(models, quantized):
    params, model = models
    jpre, jc, tc = _caches(models, quantized)
    pos = int(jpre.next_rope_pos)
    jl, jc2 = jdec.decode_step(params["llm"], jc, jnp.asarray(5), jnp.asarray(pos), LLM, **F32)
    tl, tc2 = tdec.decode_step(model.language_model, tc, 5, pos, LLM, compute_dtype=torch.float32)
    assert tl.shape == (LLM.vocab_size,) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc2 is tc and int(tc.length) == jpre.seq_len + 1  # extended in place
    _assert_cache_equal(tc, jc2, rows=jpre.seq_len + 1, tol=dict(atol=1e-4, rtol=1e-4))
    # a second step reads the row the first one wrote
    jl2, _ = jdec.decode_step(params["llm"], jc2, jnp.asarray(9), jnp.asarray(pos + 1), LLM, **F32)
    tl2, _ = tdec.decode_step(model.language_model, tc, 9, pos + 1, LLM, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **LOGIT_TOL)


def test_decode_step_on_a_long_cache_splits_the_value_product(models, rng):
    """On a cache of more than one slice of 256 rows, P.V is summed from one
    partial product per slice: the same numbers, against the plain product
    and against JAX."""
    p = torch.from_numpy(rng.random((2, 2, 4, 1024)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 1024, 16)).astype(np.float32))
    np.testing.assert_allclose(tdec._probs_times_values(p, v).numpy(), torch.matmul(p, v).numpy(), atol=1e-4, rtol=1e-5)
    for c in (1000, 300):  # a shorter last slice
        np.testing.assert_allclose(tdec._probs_times_values(p[..., :c], v[:, :, :c]).numpy(),
                                   torch.matmul(p[..., :c], v[:, :, :c]).numpy(), atol=1e-4, rtol=1e-5)
    assert torch.equal(tdec._probs_times_values(p[..., :200], v[:, :, :200]), torch.matmul(p[..., :200], v[:, :, :200]))
    params, model = models
    jpre, jc, tc = _caches(models, False, capacity=600)
    pos = int(jpre.next_rope_pos)
    jl, _ = jdec.decode_step(params["llm"], jc, jnp.asarray(5), jnp.asarray(pos), LLM, **F32)
    tl, _ = tdec.decode_step(model.language_model, tc, 5, pos, LLM, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_int8_kv_logits_stay_near_the_unquantised_ones(models):
    _, model = models
    jpre, _, tc = _caches(models, quantized=False)
    _, _, tq = _caches(models, quantized=True)
    pos = int(jpre.next_rope_pos)
    full, _ = tdec.decode_step(model.language_model, tc, 5, pos, LLM, compute_dtype=torch.float32)
    quant, _ = tdec.decode_step(model.language_model, tq, 5, pos, LLM, compute_dtype=torch.float32)
    assert ((quant - full).abs().max() / full.abs().max()).item() < 2e-2


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_generate_greedy_ids_equal_jax(models, quantized):
    params, model = models
    jpre, jc, tc = _caches(models, quantized)
    pos = int(jpre.next_rope_pos)
    jt, jn, _ = jdec.generate(params["llm"], jc, jnp.asarray(3), jnp.asarray(pos), eos_token_id=EOS, cfg=LLM,
                              max_new_tokens=7, **F32)
    tt, tn, tc2 = tdec.generate(model.language_model, tc, 3, pos, EOS, LLM, max_new_tokens=7,
                                compute_dtype=torch.float32)
    assert int(tn) == int(jn) and tc2 is tc
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tc.length) == jpre.seq_len + int(tn)


def test_generate_stops_at_eos_and_pads_with_it(models):
    """With the eos id set to the second token the greedy loop emits, the loop
    stops there: num == 2, the rest of the buffer is eos, the cache grew by 2."""
    params, model = models
    jpre, jc, tc = _caches(models, False)
    pos = int(jpre.next_rope_pos)
    free, _, _ = tdec.generate(model.language_model, tc, 3, pos, -1, LLM, max_new_tokens=4,
                               compute_dtype=torch.float32)
    eos = int(free[1])
    _, jc, tc = _caches(models, False)
    jt, jn, _ = jdec.generate(params["llm"], jc, jnp.asarray(3), jnp.asarray(pos), eos_token_id=eos, cfg=LLM,
                              max_new_tokens=6, **F32)
    tt, tn, _ = tdec.generate(model.language_model, tc, 3, pos, eos, LLM, max_new_tokens=6,
                              compute_dtype=torch.float32)
    first = free.tolist().index(eos) + 1
    assert int(tn) == int(jn) == first
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt[first:] == eos).all() and int(tc.length) == jpre.seq_len + first


def test_generate_batched_ids_equal_jax_and_the_single_loop(models):
    params, model = models
    starts, cap = [5, 9, 123], 32
    singles = []
    for s in starts:
        toks, n, _ = tdec.generate(model.language_model, tdec.make_cache(LLM, cap, torch.float32, device="cpu"),
                                   s, 0, EOS, LLM, max_new_tokens=6, compute_dtype=torch.float32)
        singles.append((toks.numpy(), int(n)))
    caches = tdec.stack_caches([tdec.make_cache(LLM, cap, torch.float32, device="cpu") for _ in starts])
    tb, nb, _ = tdec.generate_batched(model.language_model, caches, starts, [0, 0, 0], EOS, LLM, max_new_tokens=6,
                                      compute_dtype=torch.float32)
    jcaches = jax.tree.map(lambda *xs: jnp.stack(xs), *[jdec.make_cache(LLM, cap, dtype=jnp.float32) for _ in starts])
    jb, jn, _ = jdec.generate_batched(params["llm"], jcaches, jnp.asarray(starts), jnp.zeros(3, jnp.int32),
                                      eos_token_id=EOS, cfg=LLM, max_new_tokens=6, **F32)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jn))
    for i, (toks, n) in enumerate(singles):
        np.testing.assert_array_equal(tb[i].numpy(), toks)
        assert int(nb[i]) == n


def test_extend_cache_equals_a_longer_prefill(models):
    """Feeding text through the decode step leaves the cache a prefill of the
    same text would have built, and the next tokens are the same."""
    params, model = models
    lm = model.language_model
    _, _, tc_prefill = _caches(models, False)
    logits, tc_ext = tdec.extend_cache(lm, tdec.make_cache(LLM, 32, torch.float32, device="cpu"), TOKS + [0, 0], 0,
                                       LLM, n_tokens=len(TOKS), compute_dtype=torch.float32)
    assert int(tc_ext.length) == len(TOKS)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc_ext, name)[:, :, : len(TOKS)].numpy(),
                                   getattr(tc_prefill, name)[:, :, : len(TOKS)].numpy(), atol=1e-4, rtol=1e-4)
    jl, jc = jdec.extend_cache(params["llm"], jdec.make_cache(LLM, 32, dtype=jnp.float32),
                               jnp.asarray(TOKS + [0, 0], jnp.int32), jnp.asarray(0, jnp.int32), LLM,
                               n_tokens=jnp.asarray(len(TOKS), jnp.int32), **F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    a, na, _ = tdec.generate(lm, tc_prefill, 3, len(TOKS), EOS, LLM, max_new_tokens=6, compute_dtype=torch.float32)
    b, nb, _ = tdec.generate(lm, tc_ext, 3, len(TOKS), EOS, LLM, max_new_tokens=6, compute_dtype=torch.float32)
    assert int(na) == int(nb) and torch.equal(a, b)


def test_sampling_takes_an_explicit_generator(models):
    _, model = models
    lm = model.language_model

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        toks, _, _ = tdec.generate(lm, tdec.make_cache(LLM, 32, torch.float32, device="cpu"), 5, 0, -1, LLM,
                                   max_new_tokens=6, do_sample=True, temperature=5.0, generator=gen,
                                   compute_dtype=torch.float32)
        return tuple(toks.tolist())

    assert run(0) == run(0)
    assert len({run(s) for s in range(3)}) > 1  # a high temperature: seeds differ
