"""DINOv3 ViT geometry encoder (port of g2vlm_tpu/models/dinov3.py), selected
by `G2VLMConfig.use_dinov3`: patch 16, a CLS token and register tokens, 2D
RoPE on the patch tokens (fp32), LayerScale, and an optional gated MLP.

Submodule names follow the HF DINOv3 key space under `dino_model.`
(`embeddings.patch_embeddings`, `layer.{i}.attention.q_proj`,
`layer.{i}.layer_scale1.lambda1`, `norm`), the keys g2vlm_tpu's
`dinov3.params_from_torch` reads. The JAX package runs this attention as a
plain einsum; the port runs it through the batched attention kernel (K1, or
K6 / K7 under autograd), which computes the same function: at 32 views of 581
rows the fp32 logits of the plain form alone would take ~0.7 GB a layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Dinov3Config
from ..ops.flash_attention import flash_batched_attention
from ..ops.linear import linear
from ..ops.norms import layer_norm
from ..ops.rope import rotate_half


class PatchEmbeddings(nn.Conv2d):
    """The stride == kernel patch convolution (its own class: its init is
    N(0, 0.02^2), not the 1/fan_in of other convolutions)."""


class Embeddings(nn.Module):
    def __init__(self, cfg: Dinov3Config):
        super().__init__()
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, d))
        self.patch_embeddings = PatchEmbeddings(cfg.num_channels, d, cfg.patch_size, stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, cfg: Dinov3Config):
        super().__init__()
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d, bias=cfg.query_bias)
        self.k_proj = nn.Linear(d, d, bias=cfg.key_bias)
        self.v_proj = nn.Linear(d, d, bias=cfg.value_bias)
        self.o_proj = nn.Linear(d, d, bias=cfg.proj_bias)


class LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(d))


class Mlp(nn.Module):
    def __init__(self, cfg: Dinov3Config):
        super().__init__()
        d, inter, bias = cfg.hidden_size, cfg.intermediate_size, cfg.mlp_bias
        if cfg.use_gated_mlp:
            self.gate_proj = nn.Linear(d, inter, bias=bias)
        self.up_proj = nn.Linear(d, inter, bias=bias)
        self.down_proj = nn.Linear(inter, d, bias=bias)


class Layer(nn.Module):
    def __init__(self, cfg: Dinov3Config):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg)
        self.layer_scale1 = LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)
        self.layer_scale2 = LayerScale(d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) in the compute dtype; cos / sin (hw, hd) fp32 for the
        patch rows (the CLS and register rows take no rope)."""
        cfg = self.cfg
        b, s, d = x.shape
        nh, dt, eps = cfg.num_attention_heads, x.dtype, cfg.layer_norm_eps
        n_prefix = 1 + cfg.num_register_tokens
        at = self.attention

        def rope(t):  # (B, S, H, hd): fp32 rotation of the patch rows
            pt = t[:, n_prefix:].float()
            pt = pt * cos[None, :, None, :] + rotate_half(pt) * sin[None, :, None, :]
            return torch.cat([t[:, :n_prefix], pt.to(t.dtype)], dim=1)

        h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        q = rope(linear(h, at.q_proj, dt).view(b, s, nh, d // nh))
        k = rope(linear(h, at.k_proj, dt).view(b, s, nh, d // nh))
        v = linear(h, at.v_proj, dt).view(b, s, nh, d // nh)
        attn = flash_batched_attention(q, k, v).reshape(b, s, d)
        x = x + linear(attn, at.o_proj, dt) * self.layer_scale1.lambda1.to(dt)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, eps)
        mlp = self.mlp
        if cfg.use_gated_mlp:
            m = F.gelu(linear(h, mlp.gate_proj, dt)) * linear(h, mlp.up_proj, dt)
        else:
            m = F.gelu(linear(h, mlp.up_proj, dt))
        return x + linear(m, mlp.down_proj, dt) * self.layer_scale2.lambda1.to(dt)


class Dinov3(nn.Module):
    def __init__(self, cfg: Dinov3Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layer = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


def patch_center_coords(hp: int, wp: int) -> np.ndarray:
    """(hp*wp, 2) patch-center (y, x) coordinates in [-1, 1]."""
    ch = np.arange(0.5, hp, dtype=np.float64) / hp
    cw = np.arange(0.5, wp, dtype=np.float64) / wp
    grid = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1).reshape(-1, 2)
    return (2.0 * grid - 1.0).astype(np.float32)


def augment_coords(
    coords: np.ndarray,
    rng: np.random.Generator,
    shift: Optional[float],
    jitter: Optional[float],
    rescale: Optional[float],
) -> np.ndarray:
    """Training-time coordinate augmentation, drawing from the caller's
    generator in the JAX package's order (shift, jitter, rescale)."""
    out = coords.copy()
    if shift is not None:
        out = out + rng.uniform(-shift, shift, (1, 2)).astype(np.float32)
    if jitter is not None:
        jr = np.log(jitter)
        out = out * np.exp(rng.uniform(-jr, jr, (1, 2))).astype(np.float32)
    if rescale is not None:
        rr = np.log(rescale)
        out = out * np.float32(np.exp(rng.uniform(-rr, rr)))
    return out


def rope_cos_sin(coords: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hw, 2) fp32 coordinates -> cos / sin (hw, head_dim) fp32."""
    inv_freq = torch.from_numpy(1.0 / theta ** np.arange(0, 1, 4.0 / head_dim, dtype=np.float32)).to(coords.device)
    ang = 2.0 * math.pi * coords[:, :, None] * inv_freq[None, None]
    ang = ang.reshape(coords.shape[0], -1).repeat(1, 2)
    return torch.cos(ang), torch.sin(ang)


def encode(
    model: Dinov3,
    images: torch.Tensor,  # (B, C, H, W), RESNET-normalized
    compute_dtype: Optional[torch.dtype] = None,
    coord_rng: Optional[np.random.Generator] = None,
    training: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """-> patch tokens (B, hp*wp, D), CLS and registers stripped, in
    `compute_dtype` (default: the parameters' dtype). With `training` and a
    `coord_rng` the rope coordinates are augmented; with `remat` every layer
    is recomputed in the backward. H and W must be multiples of the patch
    size: recon_from_frames at new_width=512 gives 288x512 views."""
    cfg = model.cfg
    b, c, h, w = images.shape
    p = cfg.patch_size
    if h % p or w % p:
        raise ValueError(f"DINOv3 views of {h}x{w} are not multiples of its patch size {p}: pass new_width as a "
                         f"multiple of {p} (new_width=512 gives 288x512 views)")
    hp, wp = h // p, w // p
    dt = compute_dtype or model.norm.weight.dtype
    emb = model.embeddings
    # a stride == kernel convolution is one matmul over (C, p, p) patch vectors
    patches = images.reshape(b, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5).reshape(b, hp * wp, c * p * p)
    proj = emb.patch_embeddings
    x = F.linear(patches.to(dt), proj.weight.reshape(proj.weight.shape[0], -1).to(dt), proj.bias.to(dt))
    d = x.shape[-1]
    x = torch.cat([emb.cls_token.reshape(1, 1, d).expand(b, 1, d).to(dt),
                   emb.register_tokens.reshape(1, -1, d).expand(b, -1, d).to(dt), x], dim=1)

    coords = patch_center_coords(hp, wp)
    if training and coord_rng is not None:
        coords = augment_coords(coords, coord_rng, cfg.pos_embed_shift, cfg.pos_embed_jitter, cfg.pos_embed_rescale)
    cos, sin = rope_cos_sin(torch.from_numpy(coords).to(images.device), cfg.head_dim, cfg.rope_theta)
    for layer in model.layer:
        x = checkpoint(layer, x, cos, sin, use_reentrant=False) if remat else layer(x, cos, sin)
    x = layer_norm(x, model.norm.weight, model.norm.bias, cfg.layer_norm_eps)
    return x[:, 1 + cfg.num_register_tokens :]
