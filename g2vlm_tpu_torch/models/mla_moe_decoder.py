"""Kimi-VL-A3B's language model as G2VLM's decoder, `layer_module` "mla_moe" (port-only: the JAX
package has no such layer). The block is DeepSeek-V3's, as the published `modeling_deepseek.py`
of moonshotai/Kimi-VL-A3B-Instruct defines it (config.MLAMoEConfig holds its sizes):

- multi-head latent attention without a q-LoRA: q_proj gives each head 128 nope and 64 rope
  columns; kv_a_proj_with_mqa gives a row's latent (512, then `kv_a_layernorm`) and one rope key
  (64) shared by the heads; kv_b_proj lifts the latent to each head's nope key and value (128
  each). RoPE (theta 800,000) on the rope columns in the published interleaved-pair form: the
  pairs (0, 1), (2, 3), ... are first split into evens and odds, then rotated by halves. Scale
  192^-0.5;
- layer 0 (`first_k_dense_replace`) a dense SwiGLU MLP; the rest a router over 64 SwiGLU experts,
  six a token (ops/moe.py), beside a shared SwiGLU of twice the expert width.

It takes G2VLM's single-weight-set role (the reference's `Qwen2VLDecoderLayer`): text, DINOv2 and
ViT rows all run the same weights, under G2VLM's masks (the DINOv2 span bidirectional), at 1-D
positions: row i of a document has position i (`TokenInfo.pos`). Recon and the chat prefill run
`decoder_forward`, the attention in its MHA form (k = [k_nope, k_pe broadcast to the heads]) on
the MLA forward kernel (ops/flash_attention.py `flash_mla_attention`); with `return_kv` each layer
also gives what the decode cache holds, its latent and rope key (`LayerLatent`), which a decode
step's layers (`decode_layers_latent`) attend over in the absorbed form: each head's nope query
taken through its slice of `kv_b_proj` into the latent space, scores against the latents plus the
rope query against the rope keys, the probabilities weighing the latents, each head's slice of
`kv_b_proj` taking the result back to its value space; the cache is one "KV head" for all heads.

Keys are the published ones under `language_model.` (`model.layers.{i}.self_attn.kv_b_proj.weight`,
`model.layers.{i}.mlp.gate.e_score_correction_bias`, `model.layers.{i}.mlp.experts.{j}.up_proj.weight`,
...). The experts are held stacked, as the grouped products read them: `RoutedExperts.gate_up`
(E, 2I, D), each expert's gate rows then its up rows, and `down` (E, D, I); its state dict gives and
takes the published per-expert keys, each a view of its slice.

Inference only: training, tensor or sequence parallelism and the int8 or two-stage attention
options raise with the configuration's name (`MLAMoEForCausalLM.check_serving`; the int8 cache and
the batched and context-sharded decode loops in inference/decoding.py).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import MLAMoEConfig
from ..ops import moe
from ..ops.attention import cache_attention
from ..ops.linear import linear as _lin
from ..ops.masks import TokenInfo
from ..ops.rope import rotate_half
from ..utils import tracing
from .mot_decoder import Mlp, RMSNorm, _mlp

NAME = "mla_moe (Kimi-VL-A3B's MLA + MoE language model)"


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not supported by layer_module {NAME}: it serves recon and chat "
                               f"on one device, with the default attention")


class LayerLatent(NamedTuple):
    c: torch.Tensor  # (S, kv_lora_rank): the normed latent
    k_pe: torch.Tensor  # (S, qk_rope_head_dim): the roped key


def rope_inv_freq(cfg: MLAMoEConfig, device) -> torch.Tensor:
    """[inv_freq, inv_freq] (qk_rope_head_dim,) fp32 on `device`: the angles over a position."""
    dim = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(np.concatenate([inv_freq] * 2)).to(device)


def rope_cos_sin(pos: torch.Tensor, cfg: MLAMoEConfig):
    """(S,) positions -> cos, sin (S, qk_rope_head_dim) fp32: angles pos * [inv_freq, inv_freq]."""
    ang = pos.float()[:, None] * rope_inv_freq(cfg, pos.device)[None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (S, ..., R) in the interleaved-pair form -> roped fp32 in the split form (evens, then odds),
    as the published `apply_rotary_pos_emb` returns it. cos / sin (S, R), broadcast over the middle."""
    xf = x.float().unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[-1],)
    return xf * cos.view(shape) + rotate_half(xf) * sin.view(shape)


class MLAttention(nn.Module):
    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        d, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(d, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, d, bias=False)


def project_q(at: MLAttention, h: torch.Tensor, cfg: MLAMoEConfig, cos, sin, dt):
    """h (S, D) normed -> (q_nope (S, H, 128) in dt, q_pe (S, H, 64) roped fp32)."""
    q = _lin(h, at.q_proj, dt).view(h.shape[0], cfg.num_attention_heads, cfg.qk_head_dim)
    return q[..., :cfg.qk_nope_head_dim], apply_rope(q[..., cfg.qk_nope_head_dim:], cos, sin)


def project_latent(at: MLAttention, h: torch.Tensor, cfg: MLAMoEConfig, cos, sin, dt) -> LayerLatent:
    """h (S, D) normed -> the row's latent (normed, dt) and roped key (dt)."""
    ckv = _lin(h, at.kv_a_proj_with_mqa, dt)
    c = at.kv_a_layernorm(ckv[:, :cfg.kv_lora_rank])
    return LayerLatent(c, apply_rope(ckv[:, cfg.kv_lora_rank:], cos, sin).to(dt))


class Router(nn.Module):
    """`MoEGate`: the router's weight (E, D) and its selection-only bias (E,)."""

    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.empty(cfg.n_routed_experts))


PUBLISHED = ("gate_proj", "up_proj", "down_proj")


class RoutedExperts(nn.Module):
    """The routed experts, stacked: gate_up (E, 2I, D), down (E, D, I). The state dict holds the
    published per-expert keys `{j}.gate_proj.weight`, `{j}.up_proj.weight`, `{j}.down_proj.weight`
    (views of the stacked slices), and loading copies each such key into its slice, so a partial
    state dict loads the experts it holds."""

    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        e, i, d = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        self.gate_up = nn.Parameter(torch.empty(e, 2 * i, d))
        self.down = nn.Parameter(torch.empty(e, d, i))
        self._register_state_dict_hook(RoutedExperts._published_keys)

    def slices(self, j: int):
        """The published leaves of expert j as views: (gate_proj, up_proj, down_proj) weights."""
        i = self.down.shape[2]
        return self.gate_up[j, :i], self.gate_up[j, i:], self.down[j]

    def published(self, prefix: str = ""):
        """(key, view) of each published leaf, expert by expert."""
        for j in range(self.down.shape[0]):
            for name, t in zip(PUBLISHED, self.slices(j)):
                yield f"{prefix}{j}.{name}.weight", t

    @staticmethod
    def _published_keys(module, state_dict, prefix, local_metadata):
        del state_dict[prefix + "gate_up"], state_dict[prefix + "down"]
        state_dict.update((k, t.detach()) for k, t in module.published(prefix))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        want = dict(self.published(prefix))
        for key, dst in want.items():
            if key not in state_dict:
                if strict:
                    missing_keys.append(key)
            elif state_dict[key].shape != dst.shape:
                error_msgs.append(f"size mismatch for {key}: {tuple(state_dict[key].shape)} in the state dict, "
                                  f"{tuple(dst.shape)} in the model")
            else:
                with torch.no_grad():
                    dst.copy_(state_dict[key])
        if strict:
            unexpected_keys.extend(k for k in state_dict if k.startswith(prefix) and k not in want)


class MoE(nn.Module):
    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = RoutedExperts(cfg)
        self.shared_experts = Mlp(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, h: torch.Tensor, layer: int = 0) -> torch.Tensor:
        """h (T, D) normed, in the compute dtype -> the routed experts' weighted sum plus the shared one."""
        cfg, dt = self.cfg, h.dtype
        with tracing.span("moe.route"):
            idx, w = moe.route(h, self.gate.weight, self.gate.e_score_correction_bias, cfg.num_experts_per_tok,
                               cfg.routed_scaling_factor, cfg.norm_topk_prob)
        y = moe.moe_experts(h, idx, w, self.experts.gate_up, self.experts.down, layer)
        with tracing.span("moe.experts"):
            return y + _mlp(h, self.shared_experts, dt)


class MLAMoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MLAMoEConfig, index: int):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.cfg, self.index = cfg, index
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = MLAttention(cfg)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = Mlp(d, cfg.intermediate_size) if index < cfg.first_k_dense_replace else MoE(cfg)

    def mlp_out(self, x: torch.Tensor) -> torch.Tensor:
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            return self.mlp(h, self.index)
        return _mlp(h, self.mlp, x.dtype)

    def forward_prefill(self, x: torch.Tensor, cos, sin, attend):
        """x (S, D) -> (x after the layer, its LayerLatent)."""
        cfg, dt = self.cfg, x.dtype
        s, nh = x.shape[0], cfg.num_attention_heads
        at = self.self_attn
        h = self.input_layernorm(x)
        q_nope, q_pe = project_q(at, h, cfg, cos, sin, dt)
        lat = project_latent(at, h, cfg, cos, sin, dt)
        kv = _lin(lat.c, at.kv_b_proj, dt).view(s, nh, cfg.qk_nope_head_dim + cfg.v_head_dim)
        q = torch.cat([q_nope, q_pe.to(dt)], -1)
        k = torch.cat([kv[..., :cfg.qk_nope_head_dim], lat.k_pe[:, None].expand(s, nh, -1)], -1)
        v = kv[..., cfg.qk_nope_head_dim:].contiguous()
        x = x + _lin(attend(q, k, v).reshape(s, -1), at.o_proj, dt)
        return x + self.mlp_out(x), lat


class MLAMoEModel(nn.Module):
    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MLAMoEDecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MLAMoEForCausalLM(nn.Module):
    """The decoder and its lm_head, with `mot_decoder.MoTForCausalLM`'s methods."""

    def __init__(self, cfg: MLAMoEConfig):
        super().__init__()
        self.model = MLAMoEModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def check_serving(self, attn_impl: str = "auto", attn_pipe: bool = False, sharded: bool = False) -> None:
        """Raise unless the attention is the default one and the model whole."""
        if attn_impl != "auto" or attn_pipe:
            raise unsupported(f"attn_impl={attn_impl!r}, attn_pipe={attn_pipe}")
        if sharded:
            raise unsupported("sharding (FSDP2 / tensor or sequence parallelism)")

    def prefill(self, seq: torch.Tensor, packed, info: TokenInfo, text_rows: torch.Tensor, attn_impl: str = "auto",
                attn_pipe: bool = False, return_kv: bool = False):
        """`decoder_forward` of every row of `seq` (S, D); a forward that would train raises."""
        self.check_serving(attn_impl, attn_pipe)
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            self.forward_train()
        with tracing.span("decoder"):
            return decoder_forward(self.model, seq, info, return_kv)

    def forward_train(self, *args, **kwargs):
        raise unsupported("training")

    def decode_pos(self, packed) -> int:  # the first decoded token's rope position: the row after the prompt
        return packed.seq_len

    def rope_inv_freq(self, device) -> torch.Tensor:
        return rope_inv_freq(self.model.cfg, device)


def decoder_forward(model: MLAMoEModel, x: torch.Tensor, info: TokenInfo, return_kv: bool = False):
    """All layers over the packed sequence x (S, D) at the 1-D positions `info.pos`, plus the
    final norm; returns the hidden states (S, D), with `return_kv` also each layer's LayerLatent."""
    from ..ops import flash_attention as fa

    cos, sin = rope_cos_sin(info.pos, model.cfg)
    h = x.to(model.norm.weight.dtype)
    plan = fa.segment_plan(info, info)  # the kernels' plan, made once for the layers

    def attend(q, k, v):
        return fa.flash_mla_attention(q, k, v, info, info, plan=plan)

    lats: List[LayerLatent] = []
    for layer in model.layers:
        h, lat = layer.forward_prefill(h, cos, sin, attend)
        if return_kv:
            lats.append(lat)
    h = model.norm(h)
    return (h, lats) if return_kv else h


def decode_layers_latent(model: MLAMoEModel, cache, x: torch.Tensor, cos, sin, cfg: MLAMoEConfig, dt: torch.dtype,
                         visible: torch.Tensor):
    """The layers of a decode step of tokens x (B, D) in the absorbed form over the `visible` (B, C)
    rows of `cache` (a batched LatentCache) -> (the last hidden state, each layer's new row fp32)."""
    nh, r, dn = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    b = x.shape[0]
    rows = []
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        h = layer.input_layernorm(x)
        q_nope, q_pe = project_q(at, h, cfg, cos, sin, dt)
        lat = project_latent(at, h, cfg, cos, sin, dt)
        w_kb = at.kv_b_proj.weight.float().view(nh, dn + cfg.v_head_dim, r)
        q_lat = torch.einsum("bhd,hdr->bhr", q_nope.float(), w_kb[:, :dn])
        row = torch.cat([lat.c, lat.k_pe], -1).float()  # (B, R + rope)
        o_lat = cache_attention(torch.cat([q_lat, q_pe], -1)[:, None], cache.kv[:, i, None],
                                cache.kv[:, i, None, :, :r], None, None, visible, cfg.qk_head_dim, row[:, None],
                                row[:, None, :r])[:, 0]
        attn = torch.einsum("bhr,hdr->bhd", o_lat, w_kb[:, dn:])
        x = x + _lin(attn.reshape(b, -1).to(dt), at.o_proj, dt)
        x = x + layer.mlp_out(x)
        rows.append(row)
    return x, rows
