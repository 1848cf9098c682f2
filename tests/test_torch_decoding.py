"""Parity of the port's KV-cache decoding (g2vlm_tpu_torch.inference.decoding)
with g2vlm_tpu.inference.decoding on the CPU in fp32 at tiny widths: the cache
fill and its int8 form, one decode step, the greedy loops, and the
teacher-forced extension; and the fused decode kernels' plain versions
against the chain they replace."""

import copy

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
from g2vlm_tpu_torch.ops import attention as tatt
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


def _on_the_fused_layers(monkeypatch):
    """Send `_decode_step` to `_fused_layers`, which runs the kernels' plain versions on the CPU."""
    monkeypatch.setattr(tdec, "_runs_fused", lambda *a: True)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_decode_step_matches_jax(models, quantized):
    _decode_step_matches_jax(models, quantized)


def test_decode_step_on_the_fused_layers_matches_jax(models, monkeypatch):
    _on_the_fused_layers(monkeypatch)
    _decode_step_matches_jax(models, False)


def _decode_step_matches_jax(models, quantized):
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
    np.testing.assert_allclose(tatt.probs_times_values(p, v).numpy(), torch.matmul(p, v).numpy(), atol=1e-4, rtol=1e-5)
    for c in (1000, 300):  # a shorter last slice
        np.testing.assert_allclose(tatt.probs_times_values(p[..., :c], v[:, :, :c]).numpy(),
                                   torch.matmul(p[..., :c], v[:, :, :c]).numpy(), atol=1e-4, rtol=1e-5)
    assert torch.equal(tatt.probs_times_values(p[..., :200], v[:, :, :200]), torch.matmul(p[..., :200], v[:, :, :200]))
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
    _generate_greedy_ids_equal_jax(models, quantized)


def test_generate_greedy_ids_on_the_fused_layers_equal_jax(models, monkeypatch):
    _on_the_fused_layers(monkeypatch)
    _generate_greedy_ids_equal_jax(models, False)


def _generate_greedy_ids_equal_jax(models, quantized):
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
    _extend_cache_equals_a_longer_prefill(models)


def test_extend_cache_on_the_fused_layers_equals_a_longer_prefill(models, monkeypatch):
    _on_the_fused_layers(monkeypatch)
    _extend_cache_equals_a_longer_prefill(models)


def _extend_cache_equals_a_longer_prefill(models):
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


# ---------------------------------------------------------------------------
# the fused decode kernels' plain versions (ops/decode_fused.py) against the chain
# ---------------------------------------------------------------------------

def _ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many steps of a's dtype lie between a and b, element by element (same-signed values)."""
    if a.dtype == torch.float32:
        return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return (a.view(torch.int16).long() - b.view(torch.int16).long()).abs()


def _fresh_rows(rng, b, kvh, g, d, cap, dtype, qk_norm):
    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dtype)

    ang = torch.from_numpy(rng.uniform(0, 300, (b, d)).astype(np.float32))
    norms = (t(d, scale=0.3) + 1, t(d, scale=0.3) + 1) if qk_norm else (None, None)
    return (t(b, kvh * g, d, scale=2), t(b, kvh, d, scale=2), t(b, kvh, d), torch.cos(ang), torch.sin(ang),
            t(b, kvh, cap, d, scale=2), t(b, kvh, cap, d), *norms)


def _chain_attention(q, k, v, cos, sin, kc, vc, length, q_norm, k_norm, eps):
    """One layer of the decode step's chain: q/k norm, apply_mrope, cache_attention, then the store of the rows."""
    from g2vlm_tpu_torch.ops.norms import rms_norm
    from g2vlm_tpu_torch.ops.rope import apply_mrope

    b, nh, d = q.shape
    kvh, cap = k.shape[1], kc.shape[2]
    if q_norm is not None:
        q, k = rms_norm(q.float(), q_norm, eps), rms_norm(k.float(), k_norm, eps)
    q, k = apply_mrope(q, k, cos, sin)
    visible = torch.arange(cap)[None, :] < length[:, None]
    out = tatt.cache_attention(q.float().view(b, kvh, nh // kvh, d), kc, vc, None, None, visible, d, k.float(), v.float())
    pos = length.clamp(0, cap - 1)
    bi = torch.arange(b)
    kc[bi, :, pos] = k.float().to(kc.dtype)
    vc[bi, :, pos] = v.float().to(vc.dtype)
    return out.reshape(b, nh * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,g,qk_norm,lengths,cap,chunks_per_split", [
    (1, 6, True, [0], 256, 1),  # no cached row: the self term alone
    (1, 6, True, [1], 256, 1),
    (1, 6, False, [127], 384, 1),  # a split less one row
    (1, 1, True, [128], 384, 1),  # a split
    (1, 6, True, [129], 384, 1),  # a split and one row
    (1, 6, True, [255, ], 640, 2),  # splits of two chunks, a split less one
    (1, 1, False, [257], 640, 2),
    (1, 6, True, [299], 300, 1),  # a ragged capacity
    (1, 6, True, [300], 300, 1),  # a full cache: the row lands on the last visible one, after the reads
    (2, 6, True, [5, 200], 300, 1),  # two sequences of unequal lengths
    (2, 1, False, [131, 0], 300, 2),
], ids=["len0", "len1", "split-1", "split", "split+1", "2chunks-1", "2chunks+1", "ragged", "full", "b2", "b2_g1"])
def test_decode_attention_plain_matches_the_chain(rng, dtype, b, g, qk_norm, lengths, cap, chunks_per_split):
    """decode_attention_plain (splits, online softmax over 128-row chunks, the last split's merge,
    the row stored after the reads) against the chain's q/k norm + apply_mrope + cache_attention + store:
    the stored rows equal up to one step of the dtype, the outputs within fp32 rounding."""
    from g2vlm_tpu_torch.ops import decode_fused as df

    kvh, d, eps = 2, 128, 1e-6
    q, k, v, cos, sin, kc, vc, qn, kn = _fresh_rows(rng, b, kvh, g, d, cap, dtype, qk_norm)
    length = torch.tensor(lengths, dtype=torch.int64)
    kc2, vc2 = kc.clone(), vc.clone()
    want = _chain_attention(q, k, v, cos, sin, kc, vc, length, qn, kn, eps)
    got = df.decode_attention_plain(q, k, v, cos, sin, kc2, vc2, length, qn, kn, eps, chunks_per_split)
    assert got.shape == (b, kvh * g * d) and got.dtype == dtype
    # fp32: the two sum in other orders; bf16: the fp32 outputs round to one step apart at most
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-2, rtol=8e-3)
    torch.testing.assert_close(got.float(), want.to(dtype).float(), **tol)
    if dtype == torch.bfloat16:
        assert _ulps_apart(got, want.to(dtype)).max() <= 1
    for a, w in ((kc2, kc), (vc2, vc)):
        assert _ulps_apart(a, w).max() <= 1
        pos = [min(n, cap - 1) for n in lengths]
        for bi in range(b):  # every other row untouched
            keep = torch.ones(cap, dtype=torch.bool)
            keep[pos[bi]] = False
            assert torch.equal(a[bi][:, keep], w[bi][:, keep])
    # the wrapper takes the plain version for a CPU tensor
    kc3, vc3 = kc.clone(), vc.clone()
    assert torch.equal(df.decode_attention(q, k, v, cos, sin, kc3, vc3, length, qn, kn, eps), df.decode_attention_plain(
        q, k, v, cos, sin, kc.clone(), vc.clone(), length, qn, kn, eps))


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_delta", [True, False], ids=["x+d", "x"])
def test_add_rms_norm_plain_matches_the_chain(rng, w_dtype, with_delta):
    """x + d then rms_norm, as decoding.py's chain computes them in bf16, against add_rms_norm_plain
    and its wrapper on the CPU: the sum bitwise, the norm up to one bf16 step on a small share."""
    from g2vlm_tpu_torch.ops import decode_fused as df
    from g2vlm_tpu_torch.ops.norms import rms_norm

    x = torch.from_numpy(rng.standard_normal((2, 1536)).astype(np.float32) * 3).to(torch.bfloat16)
    d = torch.from_numpy(rng.standard_normal((2, 1536)).astype(np.float32)).to(torch.bfloat16) if with_delta else None
    w = torch.from_numpy(1 + 0.2 * rng.standard_normal(1536).astype(np.float32)).to(w_dtype)
    s_want = x + d if with_delta else x
    y_want = rms_norm(s_want, w, 1e-6)
    for fn in (df.add_rms_norm_plain, df.add_rms_norm):
        s, y = fn(x, d, w, 1e-6)
        assert torch.equal(s, s_want) and y.dtype == torch.bfloat16
        apart = _ulps_apart(y, y_want)
        assert apart.max() <= 1 and (apart > 0).float().mean() < 1e-2


def test_the_step_runs_the_chain_for_int8_a_group_and_the_cpu(models, monkeypatch):
    """`_runs_fused` takes the kernels only for a CUDA cache, unquantised, in the compute dtype
    (bf16 / fp16), whole on this rank, of the head dim and GQA group the kernel is built for; a
    CPU loop never reaches the kernels' wrappers and counts its steps but no fused one."""
    import dataclasses
    from types import SimpleNamespace

    from g2vlm_tpu_torch.config import G2VLMConfig
    from g2vlm_tpu_torch.ops import decode_fused as df
    from g2vlm_tpu_torch.utils import tracing

    main = G2VLMConfig().llm  # 12:2 heads of 128

    def cache(is_cuda=True, dtype=torch.bfloat16, quantized=False):
        leaf = SimpleNamespace(is_cuda=is_cuda, dtype=torch.int8 if quantized else dtype)
        return tdec.KVCache(leaf, leaf, leaf if quantized else None, leaf if quantized else None, None)

    assert tdec._runs_fused(cache(), torch.bfloat16, None, main)
    assert tdec._runs_fused(cache(dtype=torch.float16), torch.float16, None, main)
    assert not tdec._runs_fused(cache(quantized=True), torch.bfloat16, None, main)  # the int8 cache
    assert not tdec._runs_fused(cache(), torch.bfloat16, object(), main)  # generate_tp's context shard
    assert not tdec._runs_fused(cache(is_cuda=False), torch.bfloat16, None, main)  # the CPU
    assert not tdec._runs_fused(cache(dtype=torch.float32), torch.float32, None, main)
    assert not tdec._runs_fused(cache(), torch.float32, None, main)  # a compute dtype other than the cache's
    assert not tdec._runs_fused(cache(), torch.bfloat16, None, LLM)  # the tiny config's head dim
    assert not tdec._runs_fused(cache(), torch.bfloat16, None, dataclasses.replace(main, num_key_value_heads=12))

    def refuse(*a, **k):
        raise AssertionError("the CPU step reached a fused kernel's wrapper")

    monkeypatch.setattr(df, "decode_attention", refuse)
    monkeypatch.setattr(df, "add_rms_norm", refuse)
    _, model = models
    for dtype in (torch.float32, torch.bfloat16):
        with tracing.record():
            with tracing.span("chat"):
                tdec.generate(model.language_model, tdec.make_cache(LLM, 32, dtype, device="cpu"), 5, 0, -1, LLM,
                              max_new_tokens=5, compute_dtype=dtype)
        assert tracing.requests()[-1].counters == {"decode.steps": 5}
    tracing.clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_fused_layers_on_the_plain_versions_equal_the_chain(models, monkeypatch, dtype):
    """`_fused_layers` (the step on the kernels' plain versions, on the CPU) against the chain: the
    same logits, the same rows in the cache, the same greedy ids."""
    _, model = models
    lm = copy.deepcopy(model.language_model).to(dtype)
    runs = []
    for fused in (False, True):
        monkeypatch.setattr(tdec, "_runs_fused", lambda *a, fused=fused: fused)
        cache = tdec.make_cache(LLM, 300, dtype, device="cpu")
        logits, _ = tdec.extend_cache(lm, cache, TOKS * 12, 0, LLM, compute_dtype=dtype)  # 132 rows: two chunks
        toks, n, _ = tdec.generate(lm, cache, 3, len(TOKS) * 12, -1, LLM, max_new_tokens=6, compute_dtype=dtype)
        runs.append((logits, cache, toks))
    (l0, c0, t0), (l1, c1, t1) = runs
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(l1, l0, **tol)
    for a, b in ((c1.k, c0.k), (c1.v, c0.v)):
        torch.testing.assert_close(a.float(), b.float(), **tol)
    assert torch.equal(c1.length, c0.length) and torch.equal(t1, t0)
