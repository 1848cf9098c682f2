"""Parity of the port's Qwen2-VL vision tower (g2vlm_tpu_torch.models.qwen_vit)
with g2vlm_tpu.models.qwen_vit on the CPU in fp32 at tiny widths: the
uniform-grid and the packed encode, the host-side packing helpers, the vision
RoPE and the weight map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.config import VitConfig as JVitConfig
from g2vlm_tpu.models import qwen_vit as jvit
from g2vlm_tpu.ops import rope as jrope
from g2vlm_tpu_torch import weights as tweights
from g2vlm_tpu_torch.config import VitConfig
from g2vlm_tpu_torch.models import qwen_vit as tvit
from g2vlm_tpu_torch.ops import flash_attention as tfa
from g2vlm_tpu_torch.ops import rope as trope

KW = dict(depth=2, embed_dim=64, hidden_size=48, num_heads=4)
TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums in another order, two layers deep


def _models(seed=0, **over):
    kw = dict(KW, **over)
    jcfg, tcfg = JVitConfig(**kw), VitConfig(**kw)
    rng = np.random.default_rng(seed)
    params = jvit.init_params(jcfg, jax.random.PRNGKey(seed))
    # every leaf perturbed, the zero biases and unit gains included
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    sd = {}
    tweights._vit(sd, params, tcfg, "")
    model = tvit.QwenVit(tcfg).eval()
    model.load_state_dict(sd, strict=True)
    return jcfg, params, model


def _patches(rng, n):
    pdim = 3 * 2 * 14 * 14
    return rng.standard_normal((n, pdim)).astype(np.float32)


def test_state_dict_keys_are_the_reference_keys_and_round_trip():
    jcfg, params, model = _models()
    keys = set(model.state_dict())
    assert "patch_embed.proj.weight" in keys and model.state_dict()["patch_embed.proj.weight"].shape == (64, 3, 2, 14, 14)
    for name in ("blocks.1.norm1.weight", "blocks.0.attn.qkv.bias", "blocks.0.attn.proj.weight", "blocks.1.norm2.bias",
                 "blocks.0.mlp.fc1.weight", "blocks.1.mlp.fc2.bias", "merger.ln_q.weight", "merger.mlp.0.weight",
                 "merger.mlp.2.bias"):
        assert name in keys, name
    back = jvit.params_from_torch(model.state_dict(), jcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("grid", [(1, 4, 6), (2, 4, 4)], ids=["one_frame", "two_frames"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_encode_matches_jax(rng, grid, act):
    jcfg, params, model = _models(hidden_act=act)
    pats = _patches(rng, int(np.prod(grid)))
    want = jvit.encode(jax.tree.map(jnp.asarray, params), jnp.asarray(pats), grid, jcfg)
    with torch.inference_mode():
        got = tvit.encode(model, torch.from_numpy(pats), grid)
    assert got.shape == (pats.shape[0] // 4, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _packed(rng, grids, pad_to):
    views = [{"patches": _patches(rng, int(np.prod(g))), "grid_thw": g} for g in grids]
    return views, tvit.pack_views(views, pad_to=pad_to), jvit.pack_views(views, pad_to=pad_to)


def test_pack_views_coords_and_row_chunks_equal_the_jax_package(rng):
    grids = [(1, 4, 6), (1, 6, 4), (1, 2, 2)]
    views, got, want = _packed(rng, grids, pad_to=56)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] == 13
    for g in grids + [(2, 4, 4)]:
        np.testing.assert_array_equal(tvit.merge_permuted_hw_coords(g), jvit.merge_permuted_hw_coords(g))
    empty_t, empty_j = tvit.pack_views([], pad_to=8), jvit.pack_views([], pad_to=8)
    for a, b in zip(empty_t[:3], empty_j[:3]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tvit.pack_views(views, pad_to=8)
    # chunk counts: fits / clean split / a split that would cut an image / the 32-view chat layout
    layouts = [
        (np.repeat(np.arange(4), 24), 1 << 14),
        (np.repeat(np.arange(4), 24), 48),
        (np.repeat(np.arange(3), 32), 48),
        (np.concatenate([np.repeat(np.arange(5), 16), np.full(16, -1)]), 32),
        (np.repeat(np.arange(8), 2916), 16384),
    ]
    for seg, max_rows in layouts:
        assert tvit.packed_row_chunks(seg, max_rows) == jvit.packed_row_chunks(seg, max_rows)
    assert tvit.packed_row_chunks(*layouts[1]) == 2 and tvit.packed_row_chunks(*layouts[4]) == 2


def test_vision_rope_matches_jax(rng):
    coords = rng.integers(0, 54, (40, 2))
    tc, ts = trope.vision_rope_cos_sin(torch.from_numpy(coords), 16)
    jc, js = jrope.vision_rope_cos_sin(jnp.asarray(coords), 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    q = rng.standard_normal((40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((40, 4, 16)).astype(np.float32)
    tq, tk = trope.apply_vision_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    jq, jk = jrope.apply_vision_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("row_chunks", [1, 2])
def test_encode_packed_matches_jax(rng, row_chunks):
    """Images of different grids in one call, each an attention segment, with
    padding rows at the tail; chunked over rows it is the same function."""
    jcfg, params, model = _models()
    grids = [(1, 4, 6), (1, 6, 4), (1, 4, 4), (1, 2, 4)]  # 24 + 24 | 16 + 8 + 24 rows of padding: halves split no image
    _, (pats, coords, seg, n_real), _ = _packed(rng, grids, pad_to=96)
    want = jvit.encode_packed(jax.tree.map(jnp.asarray, params), jnp.asarray(pats), jnp.asarray(coords),
                              jnp.asarray(seg), jcfg, row_chunks=row_chunks)
    tfa.reset_launch_counts()
    with torch.inference_mode():
        got = tvit.encode_packed(model, torch.from_numpy(pats), torch.from_numpy(coords), torch.from_numpy(seg),
                                 row_chunks=row_chunks)
    assert got.shape == (24, 48) and n_real == 18
    np.testing.assert_allclose(got[:n_real].numpy(), np.asarray(want)[:n_real], **TOL)
    assert not any(tfa.launch_counts.values())
    if row_chunks == 2:
        with torch.inference_mode():
            whole = tvit.encode_packed(model, torch.from_numpy(pats), torch.from_numpy(coords), torch.from_numpy(seg))
        np.testing.assert_allclose(got[:n_real].numpy(), whole[:n_real].numpy(), atol=1e-5, rtol=1e-5)
        with pytest.raises(ValueError):
            tvit.encode_packed(model, torch.from_numpy(pats[:94]), torch.from_numpy(coords[:94]),
                               torch.from_numpy(seg[:94]), row_chunks=4)


def test_encode_packed_of_one_uniform_grid_equals_encode(rng):
    _, _, model = _models()
    grid = (1, 4, 6)
    pats = torch.from_numpy(_patches(rng, 24))
    coords = torch.from_numpy(tvit.merge_permuted_hw_coords(grid))
    with torch.inference_mode():
        a = tvit.encode(model, pats, grid)
        b = tvit.encode_packed(model, pats, coords, torch.zeros(24, dtype=torch.int32))
        c = tvit.encode_packed(model, pats, coords, torch.zeros(24, dtype=torch.int32), attn_impl="int8",
                               attn_pipe=True)  # below the int8 size rule, and pipelined is K2's function
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(b, c)
