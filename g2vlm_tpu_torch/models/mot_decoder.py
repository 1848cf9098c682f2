"""Mixture-of-Transformers Qwen2-VL decoder (port of
g2vlm_tpu/models/mot_decoder.py): the GEO_MAIN prefill of recon and the MIXED
and SPLIT expert modes of training and of the chat prefill.

Submodule names follow the reference key space under `language_model.`
(`model.layers.{i}.self_attn.q_proj_moe_geo`, `model.layers.{i}.ls1.gamma`,
...), so `state_dict()` feeds g2vlm_tpu's `mot_decoder.params_from_torch`.

GEO_MAIN (`decoder_forward`): the geometry expert runs on every row, then the
few "und" (text) rows are recomputed with the base expert and written back
with `index_copy`; matmuls run in the parameters' dtype. Training
(`decoder_forward_train`): MIXED computes both experts on every row and
selects per row by `is_geo`; SPLIT takes a sorted [und | geo] layout with a
static boundary and runs each expert on its contiguous slice. There the
parameters may be fp32 masters: every use casts them to the compute dtype, as
the JAX code does, and layers (or groups of layers) are recomputed in the
backward with `torch.utils.checkpoint`. In every mode the RMS norms, the
per-head qk-norm and mRoPE run in fp32. With `return_kv` a forward also gives
each layer's roped K and V (`LayerKV`), which the decode cache is built from;
`attn_impl` and `attn_pipe` are the serving options of `ops.attention`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig

from ..ops.attention import self_attender
from ..ops.linear import linear as _lin
from ..ops.masks import TokenInfo
from ..ops.norms import rms_norm
from ..ops.rope import mrope_cos_sin, rotate_half


class LayerKV(NamedTuple):
    k: torch.Tensor  # (S, KVH, HD), roped
    v: torch.Tensor


MIXED = "mixed"  # route per token by is_geo: both experts computed, one selected
SPLIT = "split"  # physical layout [und | geo] with a static boundary geo_start


def _mlp(x: torch.Tensor, mlp: "Mlp", dt: torch.dtype) -> torch.Tensor:
    return _lin(F.silu(_lin(x, mlp.gate_proj, dt)) * _lin(x, mlp.up_proj, dt), mlp.down_proj, dt)


def _norm_rope(x, gamma, cos, sin, eps: float, dt: torch.dtype) -> torch.Tensor:
    """Per-head fp32 RMS qk-norm (gamma (hd,), per-row (S, 1, hd), or None for
    no norm) then mRoPE of (S, heads, hd); returns the compute dtype."""
    xf = x.float()
    if gamma is not None:
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * gamma.float()
    return (xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(d))


class Mlp(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, d: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, inter, bias=False)
        self.up_proj = nn.Linear(d, inter, bias=False)
        self.down_proj = nn.Linear(inter, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoTAttention(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        for sfx in ("", "_moe_geo"):
            setattr(self, "q_proj" + sfx, nn.Linear(d, nh * hd))
            setattr(self, "k_proj" + sfx, nn.Linear(d, kvh * hd))
            setattr(self, "v_proj" + sfx, nn.Linear(d, kvh * hd))
            setattr(self, "o_proj" + sfx, nn.Linear(nh * hd, d, bias=False))
            setattr(self, "q_norm" + sfx, RMSNorm(hd, cfg.rms_norm_eps))
            setattr(self, "k_norm" + sfx, RMSNorm(hd, cfg.rms_norm_eps))


def _head_norm(x: torch.Tensor, norm: RMSNorm) -> torch.Tensor:
    """Per-head fp32 RMS norm of (S, heads, hd); returns fp32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + norm.eps) * norm.weight.float()


class MoTDecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        if cfg.layer_module != "mot":
            raise NotImplementedError(f"layer_module {cfg.layer_module!r}: only 'mot' is ported")
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.cfg = cfg
        self.input_layernorm = RMSNorm(d, eps)
        self.input_layernorm_moe_geo = RMSNorm(d, eps)
        self.self_attn = MoTAttention(cfg)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.post_attention_layernorm_moe_geo = RMSNorm(d, eps)
        self.mlp = Mlp(d, cfg.intermediate_size)
        self.mlp_moe_geo = Mlp(d, cfg.intermediate_size)
        self.ls1 = LayerScale(d)
        self.ls2 = LayerScale(d)

    def forward_geo_main(
        self,
        x: torch.Tensor,  # (S, D)
        und_idx: torch.Tensor,  # (T,) int64 rows of the und (text) tokens
        cos: torch.Tensor,  # (S, hd) fp32
        sin: torch.Tensor,
        attend,  # (q, k, v) -> (S, H, hd): `ops.attention.self_attender` of the sequence
        return_kv: bool = False,
    ):
        cfg = self.cfg
        nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        s = x.shape[0]
        at = self.self_attn

        h_geo = self.input_layernorm_moe_geo(x)
        h_und = self.input_layernorm(x[und_idx])
        q = at.q_proj_moe_geo(h_geo).index_copy_(0, und_idx, at.q_proj(h_und)).view(s, nh, hd)
        k = at.k_proj_moe_geo(h_geo).index_copy_(0, und_idx, at.k_proj(h_und)).view(s, kvh, hd)
        v = at.v_proj_moe_geo(h_geo).index_copy_(0, und_idx, at.v_proj(h_und)).view(s, kvh, hd)
        if cfg.qk_norm:
            q = _head_norm(q, at.q_norm_moe_geo).index_copy_(0, und_idx, _head_norm(q[und_idx], at.q_norm))
            k = _head_norm(k, at.k_norm_moe_geo).index_copy_(0, und_idx, _head_norm(k[und_idx], at.k_norm))
        q, k = q.float(), k.float()
        c, sn = cos[:, None, :], sin[:, None, :]
        q = (q * c + rotate_half(q) * sn).to(x.dtype)
        k = (k * c + rotate_half(k) * sn).to(x.dtype)

        attn = attend(q, k, v).reshape(s, nh * hd)
        out = (at.o_proj_moe_geo(attn) * self.ls1.gamma).index_copy_(0, und_idx, at.o_proj(attn[und_idx]))
        x = x + out

        m = self.mlp_moe_geo(self.post_attention_layernorm_moe_geo(x)) * self.ls2.gamma
        m = m.index_copy_(0, und_idx, self.mlp(self.post_attention_layernorm(x[und_idx])))
        return (x + m, LayerKV(k, v)) if return_kv else x + m

    def forward_train(
        self,
        x: torch.Tensor,  # (S, D) in the compute dtype
        is_geo: torch.Tensor,  # (S,) bool; read in MIXED only
        cos: torch.Tensor,  # (S, hd) fp32
        sin: torch.Tensor,
        attend,  # (q, k, v) -> (S, H, hd): `ops.attention.self_attender` of the sequence
        geo_start: Optional[int],  # None: MIXED; else SPLIT with rows [geo_start:] on the geo expert
        return_kv: bool = False,
    ):
        cfg = self.cfg
        nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        s, dt, eps = x.shape[0], x.dtype, cfg.rms_norm_eps
        at = self.self_attn
        ls1, ls2 = self.ls1.gamma.to(dt), self.ls2.gamma.to(dt)

        if geo_start is None:
            sel = is_geo[:, None]

            def both(f_und, f_geo, t):  # each expert on every row, one kept per row
                return torch.where(sel, f_geo(t), f_und(t))
        else:
            b = geo_start

            def both(f_und, f_geo, t):  # each expert on its contiguous slice
                return torch.cat([f_und(t[:b]), f_geo(t[b:])], dim=0)

        def proj(und, geo, ln_und, ln_geo):
            return both(lambda t: _lin(ln_und(t), und, dt), lambda t: _lin(ln_geo(t), geo, dt), x)

        ln_u, ln_g = self.input_layernorm, self.input_layernorm_moe_geo
        q = proj(at.q_proj, at.q_proj_moe_geo, ln_u, ln_g).view(s, nh, hd)
        k = proj(at.k_proj, at.k_proj_moe_geo, ln_u, ln_g).view(s, kvh, hd)
        v = proj(at.v_proj, at.v_proj_moe_geo, ln_u, ln_g).view(s, kvh, hd)
        if not cfg.qk_norm:
            q, k = _norm_rope(q, None, cos, sin, eps, dt), _norm_rope(k, None, cos, sin, eps, dt)
        elif geo_start is None:
            gm = is_geo[:, None, None]
            q = _norm_rope(q, torch.where(gm, at.q_norm_moe_geo.weight, at.q_norm.weight), cos, sin, eps, dt)
            k = _norm_rope(k, torch.where(gm, at.k_norm_moe_geo.weight, at.k_norm.weight), cos, sin, eps, dt)
        else:
            def nr(t, g_und, g_geo):
                return torch.cat([
                    _norm_rope(t[:b], g_und.weight, cos[:b], sin[:b], eps, dt),
                    _norm_rope(t[b:], g_geo.weight, cos[b:], sin[b:], eps, dt),
                ], dim=0)

            q, k = nr(q, at.q_norm, at.q_norm_moe_geo), nr(k, at.k_norm, at.k_norm_moe_geo)

        attn = attend(q, k, v).reshape(s, nh * hd)
        # LayerScale on the geo expert's rows only
        x = x + both(lambda t: _lin(t, at.o_proj, dt), lambda t: _lin(t, at.o_proj_moe_geo, dt) * ls1, attn)
        x = x + both(
            lambda t: _mlp(self.post_attention_layernorm(t), self.mlp, dt),
            lambda t: _mlp(self.post_attention_layernorm_moe_geo(t), self.mlp_moe_geo, dt) * ls2,
            x,
        )
        return (x, LayerKV(k, v)) if return_kv else x


class MoTModel(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MoTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.norm_moe_geo = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MoTForCausalLM(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.model = MoTModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)  # chat path; kept for the key space


def embed_tokens(model: MoTModel, token_ids: torch.Tensor) -> torch.Tensor:
    return model.embed_tokens(token_ids)


def decoder_forward(
    model: MoTModel,
    x: torch.Tensor,  # (S, D) embedded packed sequence
    position_ids: torch.Tensor,  # (3, S)
    info: TokenInfo,
    und_idx: torch.Tensor,  # (T,) rows routed to the und expert
    attn_impl: str = "auto",
    attn_pipe: bool = False,
    return_kv: bool = False,
):
    """All layers in GEO_MAIN routing plus the final norm; returns the
    hidden states (S, D), with `return_kv` also the layers' `LayerKV`s."""
    cfg = model.cfg
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    h = x.to(model.norm.weight.dtype)
    attend = self_attender(info, attn_impl, attn_pipe)
    kvs: List[LayerKV] = []
    for layer in model.layers:
        h = layer.forward_geo_main(h, und_idx, cos, sin, attend, return_kv)
        if return_kv:
            h, kv = h
            kvs.append(kv)
    hu = model.norm(h[und_idx])
    h = model.norm_moe_geo(h).index_copy_(0, und_idx, hu)
    return (h, kvs) if return_kv else h


def decoder_forward_train(
    model: MoTModel,
    x: torch.Tensor,  # (S, D) embedded packed sequence
    is_geo: torch.Tensor,  # (S,) bool
    position_ids: torch.Tensor,  # (3, S)
    info: TokenInfo,
    geo_start: Optional[int] = None,  # None: MIXED; an int: SPLIT at that row
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    remat_group: int = 1,
    remat_inner: bool = True,
    attn_impl: str = "auto",
    attn_pipe: bool = False,
    return_kv: bool = False,
):
    """All layers in MIXED or SPLIT routing plus the final norm; returns the
    hidden states (S, D) in the compute dtype, with `return_kv` (the chat
    prefill: no checkpointing) also the layers' `LayerKV`s. With `remat` every layer is
    recomputed in the backward; `remat_group` > 1 checkpoints groups of that
    many layers instead (one saved carry per group), with the per-layer
    checkpoint nested inside unless `remat_inner` is off."""
    cfg = model.cfg
    if cfg.layer_module != "mot":
        raise NotImplementedError(f"layer_module {cfg.layer_module!r}: only 'mot' is ported")
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    h = x.to(compute_dtype)
    n_layers = len(model.layers)
    grouped = remat and remat_group > 1
    if grouped and n_layers % remat_group:
        raise ValueError(f"remat_group {remat_group} does not divide {n_layers} layers")

    if return_kv and remat:
        raise ValueError("return_kv is the inference prefill: it does not checkpoint")
    attend = self_attender(info, attn_impl, attn_pipe)
    kvs: List[LayerKV] = []

    def run_layer(layer, h):
        out = layer.forward_train(h, is_geo, cos, sin, attend, geo_start, return_kv)
        if return_kv:
            kvs.append(out[1])
            return out[0]
        return out

    def run_layers(layers, h, per_layer_remat):
        for layer in layers:
            h = checkpoint(run_layer, layer, h, use_reentrant=False) if per_layer_remat else run_layer(layer, h)
        return h

    if grouped:
        for g0 in range(0, n_layers, remat_group):
            group = model.layers[g0 : g0 + remat_group]
            h = checkpoint(run_layers, group, h, remat_inner, use_reentrant=False)
    else:
        h = run_layers(model.layers, h, remat)

    if geo_start is None:
        h = torch.where(is_geo[:, None], model.norm_moe_geo(h), model.norm(h))
    else:
        h = torch.cat([model.norm(h[:geo_start]), model.norm_moe_geo(h[geo_start:])], dim=0)
    return (h, kvs) if return_kv else h


def lm_head(lm: MoTForCausalLM, hidden: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Logits at the promoted dtype of hidden and the weight (fp32 masters
    give a true fp32 product on the few supervised rows), returned as
    `out_dtype`."""
    w = lm.lm_head.weight
    ct = torch.promote_types(hidden.dtype, w.dtype)
    return F.linear(hidden.to(ct), w.to(ct)).to(out_dtype)
