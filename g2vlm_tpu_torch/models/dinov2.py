"""DINOv2-with-registers geometry encoder (port of g2vlm_tpu/models/dinov2.py).

Submodule names follow the reference (HF) key space under `dino_model.`, so
that `state_dict()` feeds g2vlm_tpu's `dinov2.params_from_torch` directly.
Views keep their real row count (782 for a 518x294 view): the batched
attention kernel masks its own ragged tail.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import DinoConfig

from ..ops.flash_attention import flash_batched_attention
from ..ops.linear import linear
from ..ops.norms import layer_norm
from ..utils.image import resize_hw


class PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        p = cfg.patch_size
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, p, stride=p)


class Embeddings(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        d = cfg.hidden_size
        n_pos = cfg.num_pos_patches_per_side ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.mask_token = nn.Parameter(torch.empty(1, d))  # unused at inference; kept for the key space
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, d))
        self.position_embeddings = nn.Parameter(torch.empty(1, n_pos + 1, d))
        self.patch_embeddings = PatchEmbeddings(cfg)


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class SelfOutput(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.attention = SelfAttention(d)
        self.output = SelfOutput(d)


class LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(d))


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Layer(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = Attention(d)
        self.layer_scale1 = LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        self.layer_scale2 = LayerScale(d)
        self.num_heads = cfg.num_attention_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) in the compute dtype; parameters are cast to it per use."""
        b, s, d = x.shape
        nh, dt = self.num_heads, x.dtype
        eps = self.norm1.eps
        sa = self.attention.attention
        h1 = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        q = linear(h1, sa.query, dt).view(b, s, nh, d // nh)
        k = linear(h1, sa.key, dt).view(b, s, nh, d // nh)
        v = linear(h1, sa.value, dt).view(b, s, nh, d // nh)
        attn = flash_batched_attention(q, k, v).reshape(b, s, d)
        x = x + linear(attn, self.attention.output.dense, dt) * self.layer_scale1.lambda1.to(dt)
        h2 = layer_norm(x, self.norm2.weight, self.norm2.bias, eps)
        h2 = linear(F.gelu(linear(h2, self.mlp.fc1, dt)), self.mlp.fc2, dt)
        return x + h2 * self.layer_scale2.lambda1.to(dt)


class Encoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))


class Dinov2(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


def interpolated_pos_embed(pos_embed: torch.Tensor, cfg: DinoConfig, hp: int, wp: int) -> torch.Tensor:
    """CLS position + the patch grid resized to (hp, wp) with antialiased
    bicubic interpolation. pos_embed (1 + n*n, D) -> (1 + hp*wp, D)."""
    n = cfg.num_pos_patches_per_side
    cls_pos, patch_pos = pos_embed[:1], pos_embed[1:]
    if (hp, wp) != (n, n):
        grid = patch_pos.reshape(n, n, -1).permute(2, 0, 1)  # (D, n, n)
        grid = resize_hw(grid, (hp, wp), mode="bicubic")
        patch_pos = grid.permute(1, 2, 0).reshape(hp * wp, -1)
    return torch.cat([cls_pos, patch_pos], dim=0)


def embed(model: Dinov2, images: torch.Tensor) -> torch.Tensor:
    """images (B, C, H, W), RESNET-normalized -> (B, 1 + R + hp*wp, D), fp32."""
    cfg = model.cfg
    emb = model.embeddings
    b, c, h, w = images.shape
    p = cfg.patch_size
    hp, wp = h // p, w // p
    # a stride == kernel convolution is one matmul over (C, p, p) patch vectors
    patches = images.float().reshape(b, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5)
    patches = patches.reshape(b, hp * wp, c * p * p)
    proj = emb.patch_embeddings.projection
    x = F.linear(patches, proj.weight.float().reshape(proj.weight.shape[0], -1), proj.bias.float())
    d = x.shape[-1]
    x = torch.cat([emb.cls_token.float().reshape(1, 1, d).expand(b, 1, d), x], dim=1)
    pos = emb.position_embeddings.float().reshape(-1, d)
    x = x + interpolated_pos_embed(pos, cfg, hp, wp)[None]
    regs = emb.register_tokens.float().reshape(1, -1, d).expand(b, -1, d)
    return torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)


def encode(
    model: Dinov2,
    images: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    remat_group: int = 1,
) -> torch.Tensor:
    """Full encoder; returns the patch tokens (B, hp*wp, D), CLS and
    registers stripped. Runs in `compute_dtype` (default: the dtype of the
    model's parameters). With `remat` every layer is recomputed in the
    backward; `remat_group` > 1 also checkpoints groups of that many layers,
    so that one carry is saved per group instead of per layer."""
    dt = compute_dtype or model.layernorm.weight.dtype
    x = embed(model, images).to(dt)
    layers = model.encoder.layer
    if remat and remat_group > 1 and len(layers) % remat_group:
        raise ValueError(f"remat_group {remat_group} does not divide {len(layers)} layers")

    def run_layers(group, x):
        for layer in group:
            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        return x

    if remat and remat_group > 1:
        for g0 in range(0, len(layers), remat_group):
            x = checkpoint(run_layers, layers[g0 : g0 + remat_group], x, use_reentrant=False)
    else:
        x = run_layers(layers, x)
    ln = model.layernorm
    x = layer_norm(x, ln.weight, ln.bias, ln.eps)
    return x[:, 1 + model.cfg.num_register_tokens :]
