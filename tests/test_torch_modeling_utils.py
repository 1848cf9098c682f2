"""The port's modeling utilities against g2vlm_tpu/models/modeling_utils.py on
the CPU: the 1D / 2D sincos tables exactly (the same float64 numpy); the
timestep features, the timestep embedder and the MLP connector within 1e-4
of max|ref| (fp32, one module each: the features' fp32 angles reach ~1e3
radians, where the two packages' exp and products round a few 1e-6 apart), on
the JAX package's own initialisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vlm_tpu.models import modeling_utils as jmu
from g2vlm_tpu_torch.models import modeling_utils as tmu
from torch_alternates import two_threads  # noqa: F401


def _load(mod, params):
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            lin = getattr(mod, name)
            lin.weight.copy_(torch.from_numpy(np.asarray(params[name]["w"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.array(params[name]["b"])))
    return mod


def _with_bias(params):
    return {k: {"w": v["w"], "b": v["b"] + 0.1} for k, v in params.items()}


@pytest.mark.parametrize("embed_dim,grid", [(16, 4), (64, 7)])
def test_sincos_tables_equal_jax(embed_dim, grid):
    np.testing.assert_array_equal(tmu.get_2d_sincos_pos_embed(embed_dim, grid),
                                  jmu.get_2d_sincos_pos_embed(embed_dim, grid))
    pos = np.arange(5, dtype=np.float64) * 1.5
    np.testing.assert_array_equal(tmu.get_1d_sincos_pos_embed(embed_dim, pos), jmu.get_1d_sincos_pos_embed(embed_dim, pos))
    assert tmu.get_2d_sincos_pos_embed(embed_dim, grid).shape == (grid * grid, embed_dim)
    with pytest.raises(ValueError, match="odd"):
        tmu.get_1d_sincos_pos_embed(7, pos)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.asarray([0.0, 1.0, 17.5, 999.0], np.float32)
    want = np.asarray(jmu.timestep_embedding(jnp.asarray(t), dim))
    got = tmu.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (4, dim)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_timestep_embedder_and_mlp_connector_match_jax(rng):
    emb = _with_bias(jmu.init_timestep_embedder(jax.random.PRNGKey(0), 48, freq_dim=64))
    t = np.asarray([3.0, 250.0, 800.0], np.float32)
    want = np.asarray(jmu.timestep_embedder(emb, jnp.asarray(t), freq_dim=64))
    with torch.no_grad():
        got = tmu.timestep_embedder(_load(tmu.TwoLayer(64, 48, 48), emb), torch.from_numpy(t), freq_dim=64).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    con = _with_bias(jmu.init_mlp_connector(jax.random.PRNGKey(1), 40, 24))
    x = rng.standard_normal((5, 40)).astype(np.float32)
    want = np.asarray(jmu.mlp_connector(con, jnp.asarray(x)))
    with torch.no_grad():
        got = tmu.mlp_connector(_load(tmu.TwoLayer(40, 24, 24), con), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
