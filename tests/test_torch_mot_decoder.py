"""Parity of the port's MoT decoder (GEO_MAIN prefill) with
g2vlm_tpu.models.mot_decoder on the CPU in fp32, at tiny widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu.models import mot_decoder as jmot
from g2vlm_tpu_torch.models import mot_decoder as tmot
from g2vlm_tpu_torch.models.g2vlm import SequenceBuilder
from g2vlm_tpu_torch.weights import state_dict_from_jax

CFG = tiny_test_config(visual_und=False)
TOL = dict(atol=2e-4, rtol=1e-3)


def _random_params(seed=0):
    """init_params with every leaf perturbed (biases, norm gains and the
    LayerScales included)."""
    rng = np.random.default_rng(seed)
    params = jg.init_params(CFG, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    params = _random_params()
    sd = state_dict_from_jax(params, CFG)
    lm = tmot.MoTForCausalLM(CFG.llm)
    prefix = "language_model."
    lm.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    return jax.tree.map(jnp.asarray, params["llm"]), lm.eval()


def _prefill(n_views=2, hp=4, wp=5, pad_to=64):
    b = SequenceBuilder(11, 12)
    b.add_text([1, 2, 3])
    b.add_dino_images(n_views, hp, wp)
    return b.build(pad_to=pad_to)


@pytest.mark.parametrize("jax_mode", [jmot.GEO_MAIN, jmot.MIXED])
def test_geo_main_decoder_matches_jax(models, rng, jax_mode):
    """The port's GEO_MAIN forward against JAX's GEO_MAIN and against JAX's
    MIXED routing (both experts everywhere, selected per row), which GEO_MAIN
    must equal up to fp32 rounding on every real row (pad rows take the geo
    expert in GEO_MAIN and the und expert in MIXED)."""
    jp, lm = models
    pre = _prefill()
    s, d = len(pre.doc_id), CFG.llm.hidden_size
    x = rng.standard_normal((s, d)).astype(np.float32)
    info = jax.tree.map(jnp.asarray, tuple(pre.token_info()))
    kw = dict(und_fixup_idx=jnp.asarray(pre.text_indexes)) if jax_mode == jmot.GEO_MAIN else {}
    want, _ = jmot.decoder_forward(
        jp, jnp.asarray(x), jnp.asarray(pre.is_geo), jnp.asarray(pre.position_ids),
        q_info=jmot.TokenInfo(*info), kv_info=None, past_kv=None, cfg=CFG.llm,
        expert_mode=jax_mode, **kw,
    )
    with torch.no_grad():
        got = tmot.decoder_forward(
            lm.model, torch.from_numpy(x), torch.from_numpy(pre.position_ids), pre.token_info(),
            und_idx=torch.from_numpy(pre.text_indexes).long(),
        )
    rows = len(pre.doc_id) if jax_mode == jmot.GEO_MAIN else pre.seq_len
    np.testing.assert_allclose(got.numpy()[:rows], np.asarray(want)[:rows], **TOL)


def test_embed_tokens_matches_jax(models):
    jp, lm = models
    ids = np.asarray([0, 5, 17, 511, 5], np.int32)
    got = lm.model.embed_tokens(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jmot.embed_tokens(jp, jnp.asarray(ids))))


def test_state_dict_keys_are_the_reference_key_space(models):
    _, lm = models
    keys = set(lm.state_dict())
    for name in (
        "model.layers.1.self_attn.q_proj_moe_geo.weight",
        "model.layers.0.self_attn.k_norm_moe_geo.weight",
        "model.layers.0.ls1.gamma",
        "model.layers.1.mlp_moe_geo.down_proj.weight",
        "model.norm_moe_geo.weight",
        "lm_head.weight",
    ):
        assert name in keys, name
