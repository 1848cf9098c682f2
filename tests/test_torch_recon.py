"""Whole-slice parity of the port (g2vlm_tpu_torch) with g2vlm_tpu on the CPU
in fp32 at tiny widths: the packed-sequence builder, the weight round trip,
`recon_forward` and `G2VLMPipeline.recon_from_frames`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import tiny_test_config
from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models import g2vlm as tg
from g2vlm_tpu_torch.models import mot_decoder as tmot
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.weights import build_model, state_dict_from_jax

_TINY = tiny_test_config(visual_und=False)
# vocab wide enough for the pipeline's crc32 fake prompt ids (< 5,100)
CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
# tests/test_recon_e2e.py's end-to-end tolerances: `points` is a derived
# product (pose @ exp(z)-scaled local points) that amplifies fp32 noise
TOLS = {"local_points": 2e-4, "camera_poses": 2e-4, "global_points": 2e-4, "points": 1e-3}


def _random_params(seed=0):
    """init_params with every leaf perturbed, the zero-initialized dino2llm,
    biases and register tokens included; the point heads' projections are
    scaled down so that exp(z) stays O(10)."""
    rng = np.random.default_rng(seed)
    params = jg.init_params(CFG, jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    for head in ("point_head", "global_point_head"):
        params[head]["proj"]["w"] = params[head]["proj"]["w"] * np.float32(0.1)
    return params


@pytest.fixture(scope="module")
def models():
    params = _random_params()
    model = build_model(CFG, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return params, model


def _assert_outputs_match(got, want):
    assert set(got) == set(want) == set(TOLS)
    for key, atol in TOLS.items():
        g = got[key].detach().cpu().numpy()
        np.testing.assert_allclose(g, np.asarray(want[key]), atol=atol, rtol=1e-3, err_msg=key)


def test_sequence_builder_matches_jax():
    jb, tb = jg.SequenceBuilder(11, 12), tg.SequenceBuilder(11, 12)
    for b in (jb, tb):
        b.add_text([7, 23, 45])
        b.add_dino_images(3, 4, 5)
        b.add_vit_image(2, 3)
        b.add_text([9])
    want, got = jb.build(pad_to=128), tb.build(pad_to=128)
    for field in jg.PackedPrefill._fields:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_weight_round_trip_is_exact(models):
    params, model = models
    sd = state_dict_from_jax(params, CFG)
    assert set(sd) == set(model.state_dict())
    back = jg.params_from_torch(sd, CFG)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = jg.params_from_torch(model.state_dict(), CFG)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_seeded_init_mirrors_init_params():
    model = build_model(CFG, device="cpu", seed=3)
    again = build_model(CFG, device="cpu", seed=3)
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    sd = model.state_dict()
    assert sd["dino2llm.weight"].abs().sum() > 0  # drawn nonzero, unlike init_params
    assert torch.all(sd["dino_model.embeddings.register_tokens"] == 0)
    assert torch.all(sd["language_model.model.layers.0.ls1.gamma"] == CFG.llm.layer_scale_init)
    assert torch.all(sd["point_decoder.blocks.0.norm1.weight"] == 1)
    w = sd["language_model.model.layers.0.mlp_moe_geo.down_proj.weight"]
    assert abs(w.std().item() * CFG.llm.intermediate_size ** 0.5 - 1.0) < 0.1


def test_recon_forward_matches_jax(models, rng):
    params, model = models
    n, h, w = 2, 56, 70  # a non-square 4x5 patch grid
    imgs = rng.standard_normal((n, 3, h, w)).astype(np.float32) * 0.3
    builders = []
    for mod in (jg, tg):
        b = mod.SequenceBuilder(11, 12)
        b.add_text([7, 23, 45])
        b.add_dino_images(n, h // 14, w // 14)
        builders.append(b.build(pad_to=64))
    want = jg.recon_forward(jax.tree.map(jnp.asarray, params), builders[0], jnp.asarray(imgs), CFG)
    tfa.reset_launch_counts()
    with torch.inference_mode():
        got = tg.recon_forward(model, builders[1], torch.from_numpy(imgs), CFG)
    _assert_outputs_match(got, want)
    # the CPU path runs the plain versions: no kernel launched
    assert not any(tfa.launch_counts.values())


def test_recon_from_frames_matches_jax_pipeline(models, rng):
    params, model = models
    frames = (rng.random((2, 54, 76, 3)) * 255).astype(np.uint8)
    jpipe = JaxPipeline(
        jax.tree.map(jnp.asarray, params), CFG, new_token_ids=dict(TOKEN_IDS),
        compute_dtype=jnp.float32, seq_pad_multiple=32,
    )
    want = jpipe.recon_from_frames(frames, new_width=70)
    pipe = G2VLMPipeline(model, CFG, new_token_ids=dict(TOKEN_IDS), seq_pad_multiple=32)
    got = pipe.recon_from_frames(frames, new_width=70)
    assert got["points"].shape == (2, 56, 70, 3) and got["camera_poses"].shape == (2, 4, 4)
    _assert_outputs_match(got, want)


def test_non_geo_dominant_prefill_matches_jax(models, rng):
    """A prefill that is not geo-dominant raises nothing: it is sorted into
    [und | geo | padding], runs the SPLIT layers and matches the JAX package."""
    params, model = models
    imgs = rng.standard_normal((1, 3, 56, 56)).astype(np.float32) * 0.3
    builders = []
    for mod in (jg, tg):
        b = mod.SequenceBuilder(11, 12)
        b.add_text(list(range(20, 40)))
        b.add_dino_images(1, 4, 4)  # 16 dino rows against 22 text rows: not geo-dominant
        builders.append(b.build(pad_to=64))
    assert not tmot._geo_dominant(CFG.llm, builders[1])
    want = jg.recon_forward(jax.tree.map(jnp.asarray, params), builders[0], jnp.asarray(imgs), CFG)
    with torch.inference_mode():
        got = tg.recon_forward(model, builders[1], torch.from_numpy(imgs), CFG)
    _assert_outputs_match(got, want)
