"""Modeling utilities (port of g2vlm_tpu/models/modeling_utils.py): the
DiT-style 2D sincos position-embedding tables, the sinusoidal timestep
embedder and the two-layer MLP connector. No model of the package calls them
(the JAX package keeps them for the reference's capability); a test holds
each against the JAX function.

The tables are host numpy. The embedder and the connector take torch
modules whose Linear weights are (out, in), as the reference's are.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def get_1d_sincos_pos_embed(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(len(pos), embed_dim) float64 table: sin then cos of pos x omega."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} is odd")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size^2, embed_dim) table: half the channels for the row, half
    for the column (the MAE recipe)."""
    gh = np.arange(grid_size, dtype=np.float64)
    gw = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, -1)
    emb_h = get_1d_sincos_pos_embed(embed_dim // 2, grid[1])
    emb_w = get_1d_sincos_pos_embed(embed_dim // 2, grid[0])
    return np.concatenate([emb_h, emb_w], axis=1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) fp32 [cos | sin] features, zero-padded to
    an odd `dim`."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TwoLayer(nn.Module):
    """fc1 and fc2: the layout of the timestep embedder and of the connector."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden)
        self.fc2 = nn.Linear(d_hidden, d_out)


def timestep_embedder(mod: TwoLayer, t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """Linear -> SiLU -> Linear over the sinusoidal features."""
    return mod.fc2(F.silu(mod.fc1(timestep_embedding(t, freq_dim))))


def mlp_connector(mod: TwoLayer, x: torch.Tensor) -> torch.Tensor:
    """Linear -> exact GELU -> Linear."""
    return mod.fc2(F.gelu(mod.fc1(x)))
