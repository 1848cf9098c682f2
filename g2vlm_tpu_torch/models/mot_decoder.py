"""Mixture-of-Transformers Qwen2-VL decoder (port of
g2vlm_tpu/models/mot_decoder.py): the GEO_MAIN prefill of recon and the MIXED
and SPLIT expert modes of training and of the chat prefill.

Submodule names follow the reference key space under `language_model.`
(`model.layers.{i}.self_attn.q_proj_moe_geo`, `model.layers.{i}.ls1.gamma`,
...), so `state_dict()` feeds g2vlm_tpu's `mot_decoder.params_from_torch`.

`cfg.layer_module` picks the layer: "mot" (both experts, LayerScale on the
geo rows), "moe" (one shared attention, `mlp_moe_geo` on the geo rows and the
final `norm_moe_geo` there) or "dense" (one set of weights, no LayerScale).
GEO_MAIN and SPLIT exist for "mot" only; "dense" and "moe" run MIXED.

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
Sharded by `parallel.mesh.shard_model`, a tensor-parallel rank holds a slice
of the projections' heads: the layers take head counts from the tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig

from ..ops import decode_fused
from ..ops.attention import cache_attention, self_attender
from ..ops.linear import linear as _lin
from ..ops.masks import TokenInfo
from ..ops.norms import rms_norm
from ..ops.rope import apply_mrope, mrope_cos_sin, rotate_half
from ..parallel.comm import is_dtensor
from ..utils import tracing


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
        return _mlp(x, self, x.dtype)


class MoTAttention(nn.Module):
    """The base expert's projections and qk-norms, and for "mot" the geo
    expert's beside them (`_moe_geo`)."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        for sfx in ("", "_moe_geo") if cfg.layer_module == "mot" else ("",):
            setattr(self, "q_proj" + sfx, nn.Linear(d, nh * hd))
            setattr(self, "k_proj" + sfx, nn.Linear(d, kvh * hd))
            setattr(self, "v_proj" + sfx, nn.Linear(d, kvh * hd))
            setattr(self, "o_proj" + sfx, nn.Linear(nh * hd, d, bias=False))
            setattr(self, "q_norm" + sfx, RMSNorm(hd, cfg.rms_norm_eps))
            setattr(self, "k_norm" + sfx, RMSNorm(hd, cfg.rms_norm_eps))


def _head_norm(x: torch.Tensor, norm: RMSNorm, weight: torch.Tensor) -> torch.Tensor:
    """Per-head fp32 RMS norm of (S, heads, hd) by `weight` (norm's, as
    `_head_weights` gives it); returns fp32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + norm.eps) * weight.float()


def _head_weights(at: MoTAttention, *names: str):
    """The qk-norm weights `names` of `at`. Under tensor parallelism they
    scale this rank's heads only, so each rank's gradient is its heads' part:
    `comm.copy_to` sums them over the group in the backward."""
    ws = [getattr(at, n).weight for n in names]
    if not is_dtensor(at.q_proj.weight):
        return ws
    from ..parallel import comm

    group = at.q_proj.weight.device_mesh.get_group()
    return [comm.copy_to(w, group) for w in ws]


LAYER_MODULES = ("mot", "moe", "dense")


class MoTDecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        if cfg.layer_module not in LAYER_MODULES:
            raise ValueError(f"layer_module {cfg.layer_module!r} is none of {LAYER_MODULES}")
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.cfg = cfg
        mot = cfg.layer_module == "mot"
        self.input_layernorm = RMSNorm(d, eps)
        if mot:
            self.input_layernorm_moe_geo = RMSNorm(d, eps)
        self.self_attn = MoTAttention(cfg)
        self.post_attention_layernorm = RMSNorm(d, eps)
        if mot:
            self.post_attention_layernorm_moe_geo = RMSNorm(d, eps)
        self.mlp = Mlp(d, cfg.intermediate_size)
        if cfg.layer_module != "dense":
            self.mlp_moe_geo = Mlp(d, cfg.intermediate_size)
        if mot:
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
        hd, dt = cfg.head_dim, x.dtype
        s = x.shape[0]
        at = self.self_attn

        def proj(geo, und):  # heads from the tensors: a tensor-parallel rank holds nh / tp and kvh / tp
            return _lin(h_geo, geo, dt).index_copy_(0, und_idx, _lin(h_und, und, dt)).view(s, -1, hd)

        h_geo = self.input_layernorm_moe_geo(x)
        h_und = self.input_layernorm(x[und_idx])
        q = proj(at.q_proj_moe_geo, at.q_proj)
        k = proj(at.k_proj_moe_geo, at.k_proj)
        v = proj(at.v_proj_moe_geo, at.v_proj)
        if cfg.qk_norm:
            wq, wk, wq_g, wk_g = _head_weights(at, "q_norm", "k_norm", "q_norm_moe_geo", "k_norm_moe_geo")
            q = _head_norm(q, at.q_norm_moe_geo, wq_g).index_copy_(0, und_idx, _head_norm(q[und_idx], at.q_norm, wq))
            k = _head_norm(k, at.k_norm_moe_geo, wk_g).index_copy_(0, und_idx, _head_norm(k[und_idx], at.k_norm, wk))
        q, k = q.float(), k.float()
        c, sn = cos[:, None, :], sin[:, None, :]
        q = (q * c + rotate_half(q) * sn).to(x.dtype)
        k = (k * c + rotate_half(k) * sn).to(x.dtype)

        attn = attend(q, k, v).reshape(s, -1)
        out = (_lin(attn, at.o_proj_moe_geo, dt) * self.ls1.gamma).index_copy_(
            0, und_idx, _lin(attn[und_idx], at.o_proj, dt))
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
        hd = cfg.head_dim
        s, dt, eps = x.shape[0], x.dtype, cfg.rms_norm_eps
        at = self.self_attn
        if cfg.layer_module != "mot":
            return self._forward_shared_attention(x, is_geo, cos, sin, attend, return_kv)
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
        q = proj(at.q_proj, at.q_proj_moe_geo, ln_u, ln_g).view(s, -1, hd)
        k = proj(at.k_proj, at.k_proj_moe_geo, ln_u, ln_g).view(s, -1, hd)
        v = proj(at.v_proj, at.v_proj_moe_geo, ln_u, ln_g).view(s, -1, hd)
        if not cfg.qk_norm:
            q, k = _norm_rope(q, None, cos, sin, eps, dt), _norm_rope(k, None, cos, sin, eps, dt)
        else:
            wq, wk, wq_g, wk_g = _head_weights(at, "q_norm", "k_norm", "q_norm_moe_geo", "k_norm_moe_geo")
            if geo_start is None:
                gm = is_geo[:, None, None]
                q = _norm_rope(q, torch.where(gm, wq_g, wq), cos, sin, eps, dt)
                k = _norm_rope(k, torch.where(gm, wk_g, wk), cos, sin, eps, dt)
            else:
                def nr(t, g_und, g_geo):
                    return torch.cat([
                        _norm_rope(t[:b], g_und, cos[:b], sin[:b], eps, dt),
                        _norm_rope(t[b:], g_geo, cos[b:], sin[b:], eps, dt),
                    ], dim=0)

                q, k = nr(q, wq, wq_g), nr(k, wk, wk_g)

        attn = attend(q, k, v).reshape(s, -1)
        # LayerScale on the geo expert's rows only
        x = x + both(lambda t: _lin(t, at.o_proj, dt), lambda t: _lin(t, at.o_proj_moe_geo, dt) * ls1, attn)
        x = x + both(
            lambda t: _mlp(self.post_attention_layernorm(t), self.mlp, dt),
            lambda t: _mlp(self.post_attention_layernorm_moe_geo(t), self.mlp_moe_geo, dt) * ls2,
            x,
        )
        return (x, LayerKV(k, v)) if return_kv else x

    def _forward_shared_attention(self, x, is_geo, cos, sin, attend, return_kv):
        """The "dense" and "moe" layers in MIXED routing: one attention for
        every row and no LayerScale; "moe" takes `mlp_moe_geo` on the geo rows."""
        cfg = self.cfg
        hd = cfg.head_dim
        s, dt, eps = x.shape[0], x.dtype, cfg.rms_norm_eps
        at = self.self_attn
        h = self.input_layernorm(x)
        q, k = _lin(h, at.q_proj, dt).view(s, -1, hd), _lin(h, at.k_proj, dt).view(s, -1, hd)
        v = _lin(h, at.v_proj, dt).view(s, -1, hd)
        gq, gk = _head_weights(at, "q_norm", "k_norm") if cfg.qk_norm else (None, None)
        q, k = _norm_rope(q, gq, cos, sin, eps, dt), _norm_rope(k, gk, cos, sin, eps, dt)
        x = x + _lin(attend(q, k, v).reshape(s, -1), at.o_proj, dt)
        h = self.post_attention_layernorm(x)
        m = _mlp(h, self.mlp, dt)
        if cfg.layer_module == "moe":
            m = torch.where(is_geo[:, None], _mlp(h, self.mlp_moe_geo, dt), m)
        return (x + m, LayerKV(k, v)) if return_kv else x + m


class MoTModel(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MoTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if cfg.use_moe:
            self.norm_moe_geo = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MoTForCausalLM(nn.Module):
    """The decoder and its lm_head; its methods are what the serving and training code ask of a
    decoder family (`mla_moe_decoder.MLAMoEForCausalLM` has the same)."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.model = MoTModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)  # chat path; kept for the key space

    def check_serving(self, attn_impl: str = "auto", attn_pipe: bool = False, sharded: bool = False) -> None:
        """Every option runs on this decoder."""

    def prefill(self, seq: torch.Tensor, packed, info: TokenInfo, text_rows: torch.Tensor, attn_impl: str = "auto",
                attn_pipe: bool = False, return_kv: bool = False):
        """The layers over an embedded `g2vlm.PackedPrefill` `seq` (S, D) -> hidden (S, D), with
        `return_kv` also the layers' `LayerKV`s. A geo-dominant prefill without ViT rows (recon)
        runs GEO_MAIN (`text_rows`, on the device, are its und rows); one that mixes und and geo
        rows (chat) is sorted stably into [und | geo | padding] and runs SPLIT (the hidden states
        un-sorted on return, the K/V left sorted); else, and for "dense" / "moe", MIXED. The
        `decoder` span holds the layers, not the sort."""
        cfg, dev = self.model.cfg, seq.device
        position_ids = torch.as_tensor(packed.position_ids).to(dev)
        kw = dict(attn_impl=attn_impl, attn_pipe=attn_pipe, return_kv=return_kv)
        if _geo_dominant(cfg, packed):
            with tracing.span("decoder"):
                return decoder_forward(self.model, seq, position_ids, info, und_idx=text_rows, **kw)
        is_geo = np.asarray(packed.is_geo)
        perm = geo_start = None
        if cfg.layer_module == "mot" and 0 < int(is_geo.sum()) < int((packed.doc_id >= 0).sum()):
            perm, geo_start = split_order(packed)
            perm_t = torch.as_tensor(perm, dtype=torch.long).to(dev)
            seq, position_ids = seq[perm_t], position_ids[:, perm_t]
            info = TokenInfo(*(f[perm_t] for f in info))
            is_geo = is_geo[perm]
        with tracing.span("decoder"):
            out = decoder_forward_train(self.model, seq, torch.as_tensor(is_geo).to(dev), position_ids, info,
                                        geo_start=geo_start, compute_dtype=seq.dtype, **kw)
        if perm is None:
            return out
        unsort = torch.as_tensor(np.argsort(perm, kind="stable"), dtype=torch.long).to(dev)
        return (out[0][unsort], out[1]) if return_kv else out[unsort]

    def forward_train(self, *args, **kwargs):  # the training forward: `decoder_forward_train`
        return decoder_forward_train(self.model, *args, **kwargs)

    def decode_pos(self, packed) -> int:  # the first decoded token's rope position: the mRoPE cursor
        return packed.next_rope_pos

    def rope_inv_freq(self, device) -> torch.Tensor:
        """[inv_freq, inv_freq] (head_dim,) fp32 on `device`: a decoded text token's one position."""
        cfg = self.model.cfg
        inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim // 2, dtype=np.float32) * 2.0 / cfg.head_dim))
        return torch.from_numpy(np.concatenate([inv_freq, inv_freq])).to(device)


def _geo_dominant(cfg: LLMConfig, packed) -> bool:
    """The GEO_MAIN routing rule of the JAX prefill: a recon prefill with a
    few text rows (the first at row 0) and many dino rows, and no vit rows."""
    n_text = len(packed.text_indexes)
    return (
        cfg.layer_module == "mot"
        and len(packed.vit_indexes) == 0
        and n_text > 0
        and len(packed.dino_indexes) > 4 * n_text
        and int(packed.text_indexes[0]) == 0
    )


def split_order(prefill) -> Tuple[np.ndarray, int]:
    """(perm, geo_start): the stable host-side sort of a mixed prefill's rows
    into [und | geo | padding], and the row where the geo expert's part
    begins."""
    key = np.where(prefill.doc_id < 0, 2, np.asarray(prefill.is_geo).astype(np.int32))
    return np.argsort(key, kind="stable"), int((key == 0).sum())


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
    if cfg.layer_module != "mot":
        raise ValueError(f"GEO_MAIN routing needs the 'mot' layer module, not {cfg.layer_module!r}")
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
    sp=None,
):
    """All layers in MIXED or SPLIT routing plus the final norm; returns the
    hidden states (S, D) in the compute dtype, with `return_kv` (the chat
    prefill: no checkpointing) also the layers' `LayerKV`s. With `remat` every layer is
    recomputed in the backward; `remat_group` > 1 checkpoints groups of that
    many layers instead (one saved carry per group), with the per-layer
    checkpoint nested inside unless `remat_inner` is off. `sp`, a process
    group, runs the attention sequence-parallel over its ranks
    (`parallel.sequence.sp_attender`) when the length divides their number,
    and ordinary attention otherwise, as the JAX dispatch does."""
    cfg = model.cfg
    if geo_start is not None and cfg.layer_module != "mot":
        raise ValueError(f"--split_layout (SPLIT routing) needs the 'mot' layer module; this model's is "
                         f"{cfg.layer_module!r}, which runs MIXED")
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    h = x.to(compute_dtype)
    n_layers = len(model.layers)
    grouped = remat and remat_group > 1
    if grouped and n_layers % remat_group:
        raise ValueError(f"remat_group {remat_group} does not divide {n_layers} layers")

    if return_kv and remat:
        raise ValueError("return_kv is the inference prefill: it does not checkpoint")
    attend = None
    if sp is not None:
        from ..parallel.sequence import sp_attender

        attend = sp_attender(info, sp, attn_impl)
    attend = attend or self_attender(info, attn_impl, attn_pipe)
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

    if not cfg.use_moe:
        h = model.norm(h)
    elif geo_start is None:
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
    if is_dtensor(w):  # the vocabulary split over tensor-parallel ranks: local logits, gathered
        from ..parallel import comm

        group = w.device_mesh.get_group()
        local = F.linear(comm.copy_to(hidden, group).to(ct), w.to_local().to(ct))
        return comm.gather(local, group, dim=-1).to(out_dtype)
    return F.linear(hidden.to(ct), w.to(ct)).to(out_dtype)


def decode_layers_fused(model: MoTModel, cache, x: torch.Tensor, cos, sin, cfg: LLMConfig,
                        dt: torch.dtype) -> torch.Tensor:
    """The und layers of a decode step of tokens x (B, D) on ops/decode_fused.py's kernels: a layer's
    `add_rms_norm` (residual add and norm) at the input and after attention, and `decode_attention`
    (q/k norms, RoPE, attention over the rows below `length` and the self term, the store of the new
    row in `cache`, a batched KVCache) between the q/k/v and the o products. Returns the final norm."""
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    b = x.shape[0]
    scratch = decode_fused.decode_scratch(b, kvh, nh // kvh, cache.k.shape[3], x.device)
    delta = None  # the last MLP's output, added to x by the next norm
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        x, h = decode_fused.add_rms_norm(x, delta, layer.input_layernorm.weight, layer.input_layernorm.eps)
        attn = decode_fused.decode_attention(
            _lin(h, at.q_proj, dt).view(b, nh, hd), _lin(h, at.k_proj, dt).view(b, kvh, hd),
            _lin(h, at.v_proj, dt).view(b, kvh, hd), cos, sin, cache.k[:, i], cache.v[:, i], cache.length,
            at.q_norm.weight if cfg.qk_norm else None, at.k_norm.weight if cfg.qk_norm else None,
            cfg.rms_norm_eps, scratch)
        x, h = decode_fused.add_rms_norm(x, _lin(attn, at.o_proj, dt), layer.post_attention_layernorm.weight,
                                         layer.post_attention_layernorm.eps)
        delta = _mlp(h, layer.mlp, dt)
    return decode_fused.add_rms_norm(x, delta, model.norm.weight, model.norm.eps)[1]


def decode_layers_chain(model: MoTModel, cache, x: torch.Tensor, cos, sin, cfg: LLMConfig, dt: torch.dtype,
                        visible: torch.Tensor, group=None, owns: Optional[torch.Tensor] = None):
    """The und layers of a decode step of tokens x (B, D) as plain tensor code over the `visible`
    (B, C) rows of `cache` (a batched KVCache, int8 or not; `group` / `owns`: `cache_attention`'s)
    -> (the last hidden state, each layer's new k and v rows (B, KVH, HD) fp32, for the caller)."""
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    b = x.shape[0]
    eps = cfg.rms_norm_eps
    quantized = cache.k_scale is not None
    k_rows, v_rows = [], []
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        h = layer.input_layernorm(x)
        q = _lin(h, at.q_proj, dt).view(b, nh, hd)
        k = _lin(h, at.k_proj, dt).view(b, kvh, hd)
        v = _lin(h, at.v_proj, dt).view(b, kvh, hd)
        if cfg.qk_norm:
            q = rms_norm(q.float(), at.q_norm.weight, eps)
            k = rms_norm(k.float(), at.k_norm.weight, eps)
        q, k = apply_mrope(q, k, cos, sin)
        k_row, v_row = k.float(), v.float()
        attn = cache_attention(
            q.float().view(b, kvh, nh // kvh, hd), cache.k[:, i], cache.v[:, i],
            cache.k_scale[:, i] if quantized else None, cache.v_scale[:, i] if quantized else None,
            visible, hd, k_row, v_row, group, owns,
        )
        x = x + _lin(attn.reshape(b, nh * hd).to(dt), at.o_proj, dt)
        x = x + _mlp(layer.post_attention_layernorm(x).to(dt), layer.mlp, dt)
        k_rows.append(k_row)
        v_rows.append(v_row)
    return x, k_rows, v_rows
