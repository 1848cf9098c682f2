"""Head dim 80, the Qwen2-VL ViT's: the plain versions of the lse forward (K3)
and the backward (K5) that the port's CPU path runs, against `jax.vjp` of the
JAX package's segment attention in interpret mode (the Pallas kernels
`_flash_kernel_lse` and `_flash_bwd` on the CPU, as its own tests run them),
on ViT layouts (each image one segment, padding rows that see nothing) and a
GQA mixed pack; and the autograd Function at D 80 against autograd through
the dense form. The CUDA kernels at D 80 are held against these plain
versions in tests/test_torch_cuda_kernels.py, on the card. CPU, fp32."""

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

D = 80
ATOL = 2e-5  # fp32 sums in another order and block size than the Pallas kernels


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """This module runs many small torch ops, which torch spreads over one thread per core by
    default; beside the other test workers that oversubscribes the machine (1.7x slower on one
    core), so the module runs on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vit_info(lens, pad):
    """Each image a segment of full attention (doc = fn = image id); padding rows -1."""
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)] + [np.full(pad, -1, np.int32)])
    return jmasks.TokenInfo(seg, seg, np.full_like(seg, -1), np.arange(len(seg), dtype=np.int32))


CASES = {
    "vit_3_images_16_16": (lambda: _vit_info([64, 36, 100], 24), 4, 4),
    "vit_one_image": (lambda: _vit_info([144], 0), 2, 2),
    "gqa_mixed_6_2": (lambda: jmasks.make_token_info_np([100, 156], [40, 60, 56, 100],
                                                        ["causal", "full", "causal", "noise"], pad_to=270), 6, 2),
}


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_forward_and_backward_at_head_dim_80_match_pallas_vjp(rng, name):
    make, h, kvh = CASES[name]
    jinfo = make()
    s = len(jinfo.doc_id)
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((s, h, D), (s, kvh, D), (s, kvh, D), (s, h, D)))
    want_out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_segment_attention(q, k, v, jinfo, jinfo, block_q=128, block_kv=128, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = vjp(jnp.asarray(co))
    tinfo = tmasks.TokenInfo(*(_t(f) for f in jinfo))
    out, lse = tfa.flash_segment_attention_lse_reference(_t(q), _t(k), _t(v), tinfo, tinfo)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    mask = tmasks.make_segment_mask(tinfo, tinfo)
    logits = torch.einsum("qhd,khd->hqk", _t(q), _t(k).repeat_interleave(h // kvh, dim=1)) * D ** -0.5
    seen = mask.any(-1)
    ref = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    np.testing.assert_allclose(lse[:, seen].numpy(), ref[:, seen].numpy(), atol=ATOL)
    assert (lse[:, ~seen] == tfa.LSE_EMPTY).all()
    got = tfa.flash_segment_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(co), tinfo, tinfo, kv_chunk=64)
    for a, b, which in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=which)
    pad = ~seen.any(0) if (jinfo.doc_id < 0).any() else None
    if pad is not None:  # rows and keys that see nothing: exact zeros
        assert all((g[pad] == 0).all() for g in got)


@pytest.mark.parametrize("name", ["vit_3_images_16_16", "gqa_mixed_6_2"])
def test_autograd_function_at_head_dim_80_matches_autograd_through_dense(rng, name):
    make, h, kvh = CASES[name]
    jinfo = make()
    s = len(jinfo.doc_id)
    tinfo = tmasks.TokenInfo(*(_t(f) for f in jinfo))
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((s, h, D), (s, kvh, D), (s, kvh, D), (s, h, D)))
    got_in = [_t(x, True) for x in (q, k, v)]
    out = tfa.flash_segment_attention(*got_in, tinfo, tinfo)
    got = torch.autograd.grad(out, got_in, _t(co))
    ref_in = [_t(x, True) for x in (q, k, v)]
    ref = tatt.segment_attention_dense(*ref_in, tinfo, tinfo)
    want = torch.autograd.grad(ref, ref_in, _t(co))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL)
    for a, b, which in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, err_msg=which)
