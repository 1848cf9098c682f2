"""The port's DINOv3 geometry encoder against g2vlm_tpu's on the CPU in fp32
at tiny widths: the patch-center coordinates, their training augmentation
drawn from one seeded numpy generator and the RoPE tables; `encode` with the
plain and the gated MLP, with and without the augmentation, within 1e-4 of
max|ref| (a single module); the state-dict round trip (the HF DINOv3 key
space under `dino_model.`); a `use_dinov3` `recon_from_frames` within the
end-to-end 1e-3; and the ValueError for views whose width is no multiple of
the patch size 16.

The JAX package's `init_params` builds DINOv2 parameters whatever
`use_dinov3` says (ROADMAP C), so the JAX side's tree gets
`dinov3.init_params` spliced in under "dino"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.inference.pipeline import G2VLMPipeline as JaxPipeline
from g2vlm_tpu.models import dinov3 as jd3
from g2vlm_tpu.models import g2vlm as jg
from g2vlm_tpu_torch import weights as tw
from g2vlm_tpu_torch.config import Dinov3Config
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models import dinov3 as td3
from torch_alternates import configs, perturbed, random_params, two_threads  # noqa: F401

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)


def _cfgs(**kw):
    return jd3.Dinov3Config(**TINY, **kw), Dinov3Config(**TINY, **kw)


def _tower(jcfg, cfg, seed=0):
    params = perturbed(jd3.init_params(jcfg, jax.random.PRNGKey(seed)), seed)
    sd = {}
    tw._dinov3(sd, params, cfg, "")
    model = td3.Dinov3(cfg)
    model.load_state_dict(sd, strict=True)
    return params, model.eval()


def test_coordinates_augmentation_and_rope_match_jax():
    coords = td3.patch_center_coords(3, 5)
    np.testing.assert_array_equal(coords, jd3.patch_center_coords(3, 5))
    for shift, jitter, rescale in ((None, None, 2.0), (0.1, 1.5, 2.0), (0.2, None, None)):
        got = td3.augment_coords(coords, np.random.default_rng(5), shift, jitter, rescale)
        want = jd3.augment_coords(coords, np.random.default_rng(5), shift, jitter, rescale)
        np.testing.assert_array_equal(got, want)
    cos, sin = td3.rope_cos_sin(torch.from_numpy(coords), 16, 100.0)
    wcos, wsin = jd3.rope_cos_sin(jnp.asarray(coords), 16, 100.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(wcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(wsin), atol=1e-6)


@pytest.mark.parametrize("gated,augmented", [(False, False), (True, False), (False, True)],
                         ids=["plain", "gated", "augmented"])
def test_encoder_matches_jax(rng, gated, augmented):
    kw = dict(use_gated_mlp=gated, pos_embed_shift=0.1 if augmented else None,
              pos_embed_jitter=1.2 if augmented else None)
    jcfg, cfg = _cfgs(**kw)
    params, model = _tower(jcfg, cfg)
    imgs = (0.5 * rng.standard_normal((2, 3, 48, 80))).astype(np.float32)
    want = jd3.encode(jax.tree.map(jnp.asarray, params), jnp.asarray(imgs), jcfg, jnp.float32,
                      coord_rng=np.random.default_rng(9), training=augmented)
    with torch.no_grad():
        got = td3.encode(model, torch.from_numpy(imgs), torch.float32, coord_rng=np.random.default_rng(9),
                         training=augmented)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 15, 64)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    if augmented:  # the augmentation moved the output
        with torch.no_grad():
            plain = td3.encode(model, torch.from_numpy(imgs), torch.float32)
        assert (plain - got).abs().max() > 1e-3


def test_state_dict_round_trip_and_remat_gradients(rng):
    jcfg, cfg = _cfgs(use_gated_mlp=True)
    params, model = _tower(jcfg, cfg)
    back = jd3.params_from_torch(model.state_dict(), jcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert "embeddings.patch_embeddings.weight" in model.state_dict()
    imgs = torch.from_numpy((0.5 * rng.standard_normal((2, 3, 32, 48))).astype(np.float32))
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        td3.encode(model, imgs, torch.float32, remat=remat).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7, msg=name)


@pytest.fixture(scope="module")
def recon_models():
    jd, td = _cfgs()
    jcfg, cfg = configs(vocab_size=5120, use_dinov3=True)
    jcfg, cfg = dataclasses.replace(jcfg, dinov3=jd), dataclasses.replace(cfg, dinov3=td)
    params = random_params(jcfg)
    params["dino"] = perturbed(jd3.init_params(jd, jax.random.PRNGKey(1)), 1)
    model = tw.build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(tw.state_dict_from_jax(params, cfg), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, params), model


def test_use_dinov3_recon_matches_jax(recon_models, rng):
    jcfg, cfg, params, model = recon_models
    assert cfg.dino_patch_size == 16 and isinstance(model.dino_model, td3.Dinov3)
    frames = (rng.random((2, 60, 80, 3)) * 255).astype(np.uint8)
    want = JaxPipeline(params, jcfg, new_token_ids=dict(TOKEN_IDS), compute_dtype=jnp.float32,
                       seq_pad_multiple=32).recon_from_frames(frames, new_width=64)
    got = G2VLMPipeline(model, cfg, new_token_ids=dict(TOKEN_IDS), seq_pad_multiple=32).recon_from_frames(
        frames, new_width=64)
    assert got["points"].shape == (2, 48, 64, 3)
    assert {k for k in want if not k.startswith("_")} == set(got)
    for key, val in got.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(want[key]), atol=1e-3, rtol=1e-3, err_msg=key)
    # a random init of the whole model: DINOv3's own distributions
    again = tw.build_model(cfg, device="cpu", seed=0).state_dict()
    assert again["dino_model.layer.0.layer_scale1.lambda1"].eq(1.0).all()
    assert abs(again["dino_model.embeddings.patch_embeddings.weight"].std().item() / 0.02 - 1) < 0.1


def test_a_view_width_that_is_no_multiple_of_16_raises(recon_models, rng):
    """target_hw(294, 518, 518, 16) gives 288x518 views, and 518 is no multiple of 16: the JAX
    package's reshape fails there; the port says which width to pass."""
    _, cfg, _, model = recon_models
    frames = (rng.random((2, 60, 80, 3)) * 255).astype(np.uint8)
    pipe = G2VLMPipeline(model, cfg, new_token_ids=dict(TOKEN_IDS), seq_pad_multiple=32)
    with pytest.raises(ValueError, match="new_width"):
        pipe.recon_from_frames(frames, new_width=70)
