"""Autoregressive decoding with a preallocated KV cache on the device (port of
g2vlm_tpu/inference/decoding.py): greedy / temperature sampling, stop at eos.

The cache is a fixed-capacity (L, KVH, C, HD) buffer per K and V (int8 with
per-(position, head) fp32 scales when quantized), written IN PLACE at a
position that is itself a tensor on the device: the step's shapes never change
and nothing in it reads the device from the host. A step attends over the
cached rows below `length` plus the token's own fresh K/V row as a separate
"self" term, collects the new rows of all layers and writes them with one
indexed store. Only the und expert runs.

On a CUDA cache in bf16 / fp16, in the compute dtype and whole on this rank,
the step runs two hand-written kernels between its products
(ops/decode_fused.py, csrc/decode_fused.cu; the JAX package has none on this
path): per layer `add_rms_norm` (the residual add and the norm after it) at
the input and after attention, and `decode_attention` (the q/k norms, the
RoPE, attention over the cache rows below `length` and the self term, and the
store of the layer's new row) between the q/k/v and the o products: ~13
kernels a layer where the chain takes ~88. The int8 cache (its scaled
dequantisation), a context-sharded cache (`generate_tp`'s merge across
ranks), head shapes the kernel is not built for and the CPU keep the chain of
plain tensor code, which the tests hold the kernels to (`_runs_fused`).

The JAX `while_loop` becomes a host loop over steps that keeps tokens,
positions, the done flags and the counts on the device. A finished sequence
makes its further steps no-ops (its cache length, count and tokens stay), so
the host looks at the done flag only every few steps. On a CUDA device a
greedy loop captures the step in a CUDA graph after one eager step and replays
it: the eager step is ~370 small launches (the chain's ~2,400) and the host
cannot issue them as fast as the card runs them. Sampling draws from an
explicit `torch.Generator` and runs eagerly. The loop counts its steps
(`decode.steps`) and those on the kernels (`decode.fused_steps`) in the
tracing recorder.

`generate_batched` advances B independent sequences, the batch as a written-out
leading axis of every cache leaf.

An "mla_moe" decoder (Kimi-VL-A3B's language model, models/mla_moe_decoder.py)
keeps a latent cache instead (`LatentCache`): per layer and row its normed
latent and roped key, 512 + 64 values, from which every head's keys and values
are one product away. Its step runs the absorbed form: each head's nope query
is taken through its slice of `kv_b_proj` into the latent space, the scores
are that against the latents plus the rope query against the rope keys, the
probabilities weigh the latents, and each head's slice of `kv_b_proj` takes
the result back to its value space before `o_proj`. The latent cache is one
"KV head" that all heads share (`_attend` with a group of H). The experts
route on the device (ops/moe.py), so the step captures in the same CUDA graph.
Only `generate`, `decode_step` and `extend_cache` take it.

Across ranks (a `torch.distributed` group): `generate_tp` splits the cache's
context axis, each rank holding a contiguous C / n rows and the whole model,
and merges each layer's softmax statistics exactly (a max, then sums: the
flash-decoding merge of the JAX package's tp_axis); `generate_batched_dp`
gives each rank its own sequences of the batch and gathers their tokens.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import LLMConfig
from ..models import mla_moe_decoder, mot_decoder
from ..models.mot_decoder import LayerKV, MoTForCausalLM
from ..ops import decode_fused
from ..ops.linear import linear
from ..ops.norms import rms_norm
from ..ops.rope import apply_mrope
from ..utils import tracing


class KVCache(NamedTuple):
    """Head-major cache: k, v (L, KVH, C, HD) (int8 when quantized), scales
    (L, KVH, C) fp32 or None, length () int64: the valid prefix. The batched
    form has a leading batch axis on every leaf. The tensors are updated in
    place by the decode step."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor


class LatentCache(NamedTuple):
    """The "mla_moe" decoder's cache: kv (L, C, kv_lora_rank + qk_rope_head_dim) in the compute
    dtype, each row its layer's normed latent then its roped key; length () int64. The batched form
    has a leading batch axis on both. Updated in place by the decode step."""

    kv: torch.Tensor
    length: torch.Tensor


def build_latent_cache(prefill_latents: List, valid_len, cfg, capacity: int,
                       dtype: torch.dtype = torch.bfloat16) -> LatentCache:
    """The latent cache from a prefill's per-layer `LayerLatent`s (consumed layer by layer, as
    `build_cache` consumes K/V), the first `valid_len` rows valid."""
    dev = prefill_latents[0].c.device
    kv = torch.zeros((cfg.num_hidden_layers, capacity, cfg.latent_dim), dtype=dtype, device=dev)
    for i in range(len(prefill_latents)):
        lat, prefill_latents[i] = prefill_latents[i], None
        s = lat.c.shape[0]
        kv[i, :s, :cfg.kv_lora_rank] = lat.c.to(dtype)
        kv[i, :s, cfg.kv_lora_rank:] = lat.k_pe.to(dtype)
    return LatentCache(kv, torch.full((), int(valid_len), dtype=torch.int64, device=dev))


def make_cache(
    cfg: LLMConfig, capacity: int, dtype: torch.dtype = torch.bfloat16, quantized: bool = False, device="cuda"
) -> KVCache:
    n_layers, kvh, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    kv_dtype = torch.int8 if quantized else dtype

    def scale():
        return torch.zeros((n_layers, kvh, capacity), dtype=torch.float32, device=device) if quantized else None

    return KVCache(
        k=torch.zeros((n_layers, kvh, capacity, hd), dtype=kv_dtype, device=device),
        v=torch.zeros((n_layers, kvh, capacity, hd), dtype=kv_dtype, device=device),
        k_scale=scale(),
        v_scale=scale(),
        length=torch.zeros((), dtype=torch.int64, device=device),
    )


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize over the last (head_dim) axis: x (..., KVH, HD) ->
    (int8 of the same shape, fp32 scale (..., KVH))."""
    xf = x.float()
    s = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-10)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def _fill_layer(cache: KVCache, layer: int, kv: LayerKV) -> None:
    for buf, scales, rows in ((cache.k, cache.k_scale, kv.k), (cache.v, cache.v_scale, kv.v)):
        rows = rows.transpose(0, 1)  # (KVH, S, HD)
        s = rows.shape[1]
        if scales is not None:
            rows, sc = _quant(rows)
            scales[layer, :, :s] = sc
        buf[layer, :, :s] = rows.to(buf.dtype)


def fill_cache(cache: KVCache, prefill_kv: Sequence[LayerKV], valid_len, consume: bool = False) -> KVCache:
    """Copy a prefill's per-layer K/V (S, KVH, HD) into the head of the cache,
    in place and layer by layer (per-layer temporaries only); rows at and past
    `valid_len` are never visible. With `consume` (a list) each layer's entry
    is dropped as soon as it is copied. Returns the cache with its length set."""
    for layer in range(len(prefill_kv)):
        kv = prefill_kv[layer]
        if consume:
            prefill_kv[layer] = None
        _fill_layer(cache, layer, kv)
    cache.length.fill_(int(valid_len))
    return cache


def build_cache(
    prefill_kv: List[LayerKV], valid_len, cfg: LLMConfig, capacity: int,
    dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
) -> KVCache:
    """`fill_cache(make_cache(...))` on the prefill's device. The prefill K/V
    list is consumed, so the peak is one cache plus what is left of the
    prefill K/V."""
    cache = make_cache(cfg, capacity, dtype, quantized, device=prefill_kv[0].k.device)
    return fill_cache(cache, prefill_kv, valid_len, consume=True)


def _attend(q, k_all, v_all, k_scale, v_scale, visible, hd, k_self, v_self, group=None, self_here=None):
    """Softmax attention of one query token per sequence over its cache plus
    the token's own fresh K/V row, which is not in the cache yet.

    q (B, KVH, G, HD) fp32; k_all / v_all (B, KVH, C, HD); scales (B, KVH, C)
    or None; visible (B, C) bool; k_self / v_self (B, KVH, HD) fp32. The
    dequantisation is folded after the products: the K scale multiplies the
    logits and the V scale the probabilities, head_dim times less work than
    scaling the cache itself. Returns (B, KVH, G, HD) fp32.

    With `group` the cache is this rank's context shard: the row max is
    merged with an all-reduce MAX, the sums l and acc with an all-reduce SUM
    (softmax is shift-invariant, so the merge is exact), and the self term
    counts only on the rank whose shard holds the position (`self_here`, (B,)
    bool), so that the sums take it once."""
    logits = torch.einsum("bngd,bncd->bngc", q, k_all.float()) * (hd ** -0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    vis = visible[:, None, None, :]
    logits = logits.masked_fill(~vis, float("-inf"))
    s_self = torch.einsum("bngd,bnd->bng", q, k_self) * (hd ** -0.5)
    if group is not None:
        s_self = s_self.masked_fill(~self_here[:, None, None], float("-inf"))
    m = torch.maximum(logits.amax(-1), s_self)  # the self term is always visible, so m is finite
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(-1) + p_self
    pv = p if v_scale is None else p * v_scale[:, :, None, :]
    acc = _probs_times_values(pv, v_all.float()) + p_self[..., None] * v_self[:, :, None, :]
    if group is not None:
        dist.all_reduce(l, group=group)
        dist.all_reduce(acc, group=group)
    return acc / l.clamp_min(1e-30)[..., None]


_PV_SPLIT = 256  # cache rows per partial product of P.V


def _probs_times_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, KVH, G, C) @ v (B, KVH, C, HD) -> (B, KVH, G, HD). A product of G
    = 6 rows with a reduction over ~50k cache rows: as one matrix product the
    library walks the whole reduction in one block per head (1.4 ms per layer
    on an H100, most of a decode step), so the cache axis is cut into slices
    of _PV_SPLIT rows (and a shorter last one), each a small product of its
    own, and the partial results are summed."""
    c = p.shape[-1]
    n = c // _PV_SPLIT
    if n < 2:
        return torch.matmul(p, v)
    whole = n * _PV_SPLIT
    parts = torch.matmul(p[..., :whole].unflatten(-1, (n, _PV_SPLIT)).transpose(2, 3),
                         v[:, :, :whole].unflatten(2, (n, _PV_SPLIT)))
    out = parts.sum(2)
    return out if whole == c else out + torch.matmul(p[..., whole:], v[:, :, whole:])


def _batched(cache):
    """The single-sequence cache (a KVCache or LatentCache) as a batch of one:
    views, so in-place writes reach the caller's tensors."""
    return type(cache)(*(None if t is None else t.unsqueeze(0) for t in cache))


def _rope_inv_freq(cfg: LLMConfig, device) -> torch.Tensor:
    """A text token has one rope position on all three mRoPE axes, so its
    angle table is pos * [inv_freq, inv_freq]: (head_dim,) fp32, made once per
    loop (an upload inside a captured step is not allowed). The "mla_moe"
    decoder's is that of its rope columns."""
    if cfg.layer_module == "mla_moe":
        inv_freq = mla_moe_decoder.rope_inv_freq(cfg)
    else:
        half = cfg.head_dim // 2
        inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / cfg.head_dim))
    return torch.from_numpy(np.concatenate([inv_freq, inv_freq])).to(device)


def _owned(owns: Optional[torch.Tensor], new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`new` where this rank's context shard holds the position (`owns` (B,)
    bool; None: the whole cache), else `old`."""
    return new if owns is None else torch.where(owns.view(-1, *[1] * (new.dim() - 1)), new, old)


def _decode_step(
    lm: MoTForCausalLM, cache: KVCache, token: torch.Tensor, rope_pos: torch.Tensor, cfg: LLMConfig,
    dt: torch.dtype, inv_freq2: torch.Tensor, active: Optional[torch.Tensor] = None, group=None,
) -> torch.Tensor:
    """One step of B sequences on a batched cache: token, rope_pos (B,) int64;
    `active` (B,) bool gates the advance of each cache's length. Writes the
    new K/V rows of every layer at each sequence's `length` in place and
    returns the logits (B, V) fp32. With `group` the cache holds this rank's
    contiguous context shard (rows [rank * C, (rank + 1) * C) of the whole,
    C its capacity here) and `length` the whole's; the rank that owns the
    position writes the rows."""
    model = lm.model
    x = model.embed_tokens(token).to(dt)  # (B, D)
    ang = rope_pos.float()[:, None] * inv_freq2[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if _runs_fused(cache, dt, group, cfg):
        h = _fused_layers(model, cache, x, cos, sin, cfg, dt)
    else:
        h = model.norm(_chain_layers(model, cache, x, cos, sin, cfg, dt, group))
    cache.length.add_(1 if active is None else active.to(cache.length.dtype))
    # the product runs in the compute dtype (an fp32 copy of the 152k-row head
    # per step would cost more than the step); the logits come back as fp32
    return mot_decoder.lm_head(lm, h.to(dt), torch.float32)


def _runs_fused(cache: KVCache, dt: torch.dtype, group, cfg: LLMConfig) -> bool:
    """Whether `_decode_step` runs the fused kernels: a CUDA cache, unquantised, in the compute
    dtype (bf16 or fp16), whole on this rank, of the head dim and GQA group the kernel is built
    for. Else the chain: the int8 cache, `generate_tp`'s context shards, other head shapes (the
    tiny test configs) and the CPU."""
    return (cache.k.is_cuda and cache.k_scale is None and group is None and cache.k.dtype == dt
            and dt in (torch.bfloat16, torch.float16) and cfg.head_dim == decode_fused.HEAD_DIM
            and cfg.num_attention_heads // cfg.num_key_value_heads in decode_fused.GROUPS)


def _fused_layers(model, cache: KVCache, x, cos, sin, cfg: LLMConfig, dt: torch.dtype) -> torch.Tensor:
    """The layers of `_decode_step` on ops/decode_fused.py's kernels, each layer's new K/V rows
    stored by its `decode_attention`; returns the final norm of the last hidden state."""
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    b = x.shape[0]
    scratch = decode_fused.decode_scratch(b, kvh, nh // kvh, cache.k.shape[3], x.device)
    delta = None  # the last MLP's output, added to x by the next norm
    for i, layer in enumerate(model.layers):
        at, mlp = layer.self_attn, layer.mlp
        x, h = decode_fused.add_rms_norm(x, delta, layer.input_layernorm.weight, layer.input_layernorm.eps)
        attn = decode_fused.decode_attention(
            linear(h, at.q_proj, dt).view(b, nh, hd), linear(h, at.k_proj, dt).view(b, kvh, hd),
            linear(h, at.v_proj, dt).view(b, kvh, hd), cos, sin, cache.k[:, i], cache.v[:, i], cache.length,
            at.q_norm.weight if cfg.qk_norm else None, at.k_norm.weight if cfg.qk_norm else None,
            cfg.rms_norm_eps, scratch)
        x, h = decode_fused.add_rms_norm(x, linear(attn, at.o_proj, dt), layer.post_attention_layernorm.weight,
                                         layer.post_attention_layernorm.eps)
        delta = linear(F.silu(linear(h, mlp.gate_proj, dt)) * linear(h, mlp.up_proj, dt), mlp.down_proj, dt)
    return decode_fused.add_rms_norm(x, delta, model.norm.weight, model.norm.eps)[1]


def _chain_layers(model, cache: KVCache, x, cos, sin, cfg: LLMConfig, dt: torch.dtype, group) -> torch.Tensor:
    """The layers of `_decode_step` as plain tensor code, then the new K/V rows of all layers in
    one indexed store; returns the last hidden state."""
    nh, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    b = x.shape[0]
    eps = cfg.rms_norm_eps
    cur = cache.length  # (B,)
    cap = cache.k.shape[3]
    offset, owns = 0, None
    if group is not None:
        offset = dist.get_rank(group) * cap
        owns = (cur >= offset) & (cur < offset + cap)
    # the cache row at the current position is stale: only strictly older rows
    # are visible, the current token's K/V enters through the self term
    visible = torch.arange(offset, offset + cap, device=x.device)[None, :] < cur[:, None]
    quantized = cache.k_scale is not None

    k_rows, v_rows = [], []
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        h = layer.input_layernorm(x)
        q = linear(h, at.q_proj, dt).view(b, nh, hd)
        k = linear(h, at.k_proj, dt).view(b, kvh, hd)
        v = linear(h, at.v_proj, dt).view(b, kvh, hd)
        if cfg.qk_norm:
            q = rms_norm(q.float(), at.q_norm.weight, eps)
            k = rms_norm(k.float(), at.k_norm.weight, eps)
        q, k = apply_mrope(q, k, cos, sin)
        k_row, v_row = k.float(), v.float()
        attn = _attend(
            q.float().view(b, kvh, nh // kvh, hd), cache.k[:, i], cache.v[:, i],
            cache.k_scale[:, i] if quantized else None, cache.v_scale[:, i] if quantized else None,
            visible, hd, k_row, v_row, group, owns,
        )
        x = x + linear(attn.reshape(b, nh * hd).to(dt), at.o_proj, dt)
        h = layer.post_attention_layernorm(x).to(dt)
        mlp = layer.mlp
        x = x + linear(F.silu(linear(h, mlp.gate_proj, dt)) * linear(h, mlp.up_proj, dt), mlp.down_proj, dt)
        k_rows.append(k_row)
        v_rows.append(v_row)

    # one indexed store of all layers' rows at each sequence's position
    n_layers = len(model.layers)
    pos = (cur - offset).clamp(0, cap - 1)
    bi = torch.arange(b, device=x.device)[:, None, None]
    li = torch.arange(n_layers, device=x.device)[None, :, None]
    hi = torch.arange(kvh, device=x.device)[None, None, :]
    pi = pos[:, None, None]
    for buf, scales, rows in ((cache.k, cache.k_scale, k_rows), (cache.v, cache.v_scale, v_rows)):
        rows = torch.stack(rows, dim=1)  # (B, L, KVH, HD) fp32
        if quantized:
            rows, sc = _quant(rows)
            scales[bi, li, hi, pi] = _owned(owns, sc, scales[bi, li, hi, pi])
        buf[bi, li, hi, pi] = _owned(owns, rows.to(buf.dtype), buf[bi, li, hi, pi])
    return x


def _latent_decode_step(
    lm, cache: LatentCache, token: torch.Tensor, rope_pos: torch.Tensor, cfg, dt: torch.dtype,
    inv_freq2: torch.Tensor, active: Optional[torch.Tensor] = None, group=None,
) -> torch.Tensor:
    """`_decode_step` of the "mla_moe" decoder on a batched latent cache, in the absorbed form."""
    if group is not None:
        raise mla_moe_decoder.unsupported("context-sharded decoding (generate_tp)")
    model = lm.model
    nh, r, dn = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    b = token.shape[0]
    x = model.embed_tokens(token).to(dt)  # (B, D)
    ang = rope_pos.float()[:, None] * inv_freq2[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    cur = cache.length  # (B,)
    cap = cache.kv.shape[2]
    # only strictly older rows are visible: the token's own latent enters through the self term
    visible = torch.arange(cap, device=x.device)[None, :] < cur[:, None]
    rows = []
    for i, layer in enumerate(model.layers):
        at = layer.self_attn
        h = layer.input_layernorm(x)
        q_nope, q_pe = mla_moe_decoder.project_q(at, h, cfg, cos, sin, dt)
        lat = mla_moe_decoder.project_latent(at, h, cfg, cos, sin, dt)
        w_kb = at.kv_b_proj.weight.float().view(nh, dn + cfg.v_head_dim, r)
        q_lat = torch.einsum("bhd,hdr->bhr", q_nope.float(), w_kb[:, :dn])
        row = torch.cat([lat.c, lat.k_pe], -1).float()  # (B, R + rope)
        o_lat = _attend(torch.cat([q_lat, q_pe], -1)[:, None], cache.kv[:, i, None], cache.kv[:, i, None, :, :r],
                        None, None, visible, cfg.qk_head_dim, row[:, None], row[:, None, :r])[:, 0]
        attn = torch.einsum("bhr,hdr->bhd", o_lat, w_kb[:, dn:])
        x = x + linear(attn.reshape(b, -1).to(dt), at.o_proj, dt)
        x = x + layer.mlp_out(x)
        rows.append(row)
    pos = cur.clamp(0, cap - 1)
    bi = torch.arange(b, device=x.device)[:, None]
    li = torch.arange(len(model.layers), device=x.device)[None, :]
    cache.kv[bi, li, pos[:, None]] = torch.stack(rows, dim=1).to(cache.kv.dtype)
    cache.length.add_(1 if active is None else active.to(cache.length.dtype))
    return mot_decoder.lm_head(lm, model.norm(x).to(dt), torch.float32)


def _step(cache):
    """The decode step that serves `cache`."""
    return _latent_decode_step if isinstance(cache, LatentCache) else _decode_step


def _as_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(-1)


@torch.inference_mode()
def decode_step(
    lm: MoTForCausalLM, cache: KVCache, token, rope_pos, cfg: LLMConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step of one sequence (und expert only): (logits (V,) fp32,
    the cache, updated in place and one row longer)."""
    dev = cache[0].device
    logits = _step(cache)(lm, _batched(cache), _as_index(token, dev), _as_index(rope_pos, dev), cfg,
                          compute_dtype, _rope_inv_freq(cfg, dev))
    return logits[0], cache


@torch.inference_mode()
def extend_cache(
    lm: MoTForCausalLM, cache: KVCache, tokens, rope_pos, cfg: LLMConfig,
    n_tokens: Optional[int] = None, compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-forced cache extension for a follow-up turn: feeds the first
    `n_tokens` of `tokens` through the decode step (each appends its K/V row
    in place). Token for token identical to having had the text in the
    prefill: text rows are causal and their rope position is the scalar
    counter, as decode rows. Returns (the last token's logits (V,), cache)."""
    dev = cache[0].device
    tokens = _as_index(tokens, dev)
    n = len(tokens) if n_tokens is None else int(n_tokens)
    pos = _as_index(rope_pos, dev)
    inv_freq2 = _rope_inv_freq(cfg, dev)
    batched = _batched(cache)
    step = _step(cache)
    logits = torch.zeros((1, cfg.vocab_size), dtype=torch.float32, device=dev)
    for i in range(n):
        logits = step(lm, batched, tokens[i : i + 1], pos + i, cfg, compute_dtype, inv_freq2)
    return logits[0], cache


_DONE_CHECK_EVERY = 8  # steps between reads of `done` on the host (a finished sequence's steps change nothing)


def _generate_loop(
    lm, cache: KVCache, start_tokens, rope_pos, eos_token_id: int, cfg: LLMConfig, max_new_tokens: int,
    do_sample: bool, temperature: float, generator: Optional[torch.Generator], dt: torch.dtype,
    cuda_graph: Optional[bool], group=None,
):
    """The loop over a batched cache; returns (tokens (B, max_new_tokens)
    padded with eos, num_generated (B,)). `group`: the cache is context-sharded
    over its ranks (`generate_tp`, which runs the loop without a CUDA graph:
    one would have to capture the step's collectives, and the sharded loop
    has not been timed on cards)."""
    dev = cache[0].device
    b = cache[0].shape[0]
    decode_step_fn = _step(cache)
    tokens = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.int64, device=dev)
    tok = _as_index(start_tokens, dev).clone()
    pos = _as_index(rope_pos, dev).clone()
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    num = torch.zeros(b, dtype=torch.int64, device=dev)
    slot = torch.zeros((1, 1), dtype=torch.int64, device=dev)  # the column of `tokens` this step writes
    inv_freq2 = _rope_inv_freq(cfg, dev)
    fused = isinstance(cache, KVCache) and _runs_fused(cache, dt, group, cfg)

    def step():
        logits = decode_step_fn(lm, cache, tok, pos, cfg, dt, inv_freq2, active=~done, group=group)
        if do_sample:
            nxt = torch.multinomial(torch.softmax(logits / temperature, dim=-1), 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        tokens.scatter_(1, slot.expand(b, 1), nxt[:, None])
        num.add_((~done).to(num.dtype))
        done.logical_or_(nxt == eos_token_id)
        tok.copy_(nxt)
        pos.add_(1)
        slot.add_(1)

    if cuda_graph is None:
        cuda_graph = dev.type == "cuda" and not do_sample and max_new_tokens > 2
    graph = None
    for i in range(max_new_tokens):
        tracing.count("decode.steps", 1)
        if fused:
            tracing.count("decode.fused_steps", 1)
        if i == 0:
            with tracing.span("decode.first"):
                step()  # eager; with a graph this is the warm-up, and a real step
                if cuda_graph and max_new_tokens > 1:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        step()  # captured, not run
        elif graph is None:
            step()
        else:
            graph.replay()
        if ((i + 1) % _DONE_CHECK_EVERY == 0 or i + 1 == max_new_tokens) and bool(done.all()):
            break
    return tokens, num


@torch.inference_mode()
def generate(
    lm: MoTForCausalLM, cache: KVCache, start_token, rope_pos, eos_token_id: int, cfg: LLMConfig,
    max_new_tokens: int = 100, do_sample: bool = False, temperature: float = 1.0,
    generator: Optional[torch.Generator] = None, compute_dtype: torch.dtype = torch.bfloat16,
    cuda_graph: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Greedy / temperature generation of one sequence. Returns (tokens
    (max_new_tokens,) padded with eos, num_generated (), the cache, extended in
    place by num_generated rows: a follow-up turn continues on it).
    `cuda_graph` None takes the graph for a greedy loop on a CUDA device."""
    tokens, num = _generate_loop(lm, _batched(cache), start_token, rope_pos, eos_token_id, cfg, max_new_tokens,
                                 do_sample, temperature, generator, compute_dtype, cuda_graph)
    return tokens[0], num[0], cache


@torch.inference_mode()
def generate_batched(
    lm: MoTForCausalLM, caches: KVCache, start_tokens, rope_pos, eos_token_id: int, cfg: LLMConfig,
    max_new_tokens: int = 100, do_sample: bool = False, temperature: float = 1.0,
    generator: Optional[torch.Generator] = None, compute_dtype: torch.dtype = torch.bfloat16,
    cuda_graph: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """B independent sequences (own caches and positions, a leading batch axis
    on every cache leaf) advance in one loop; the per-token weight reads are
    shared by the batch. A finished sequence emits eos and stops counting.
    Returns (tokens (B, max_new_tokens), num_generated (B,), the caches)."""
    if isinstance(caches, LatentCache):
        raise mla_moe_decoder.unsupported("generate_batched")
    tokens, num = _generate_loop(lm, caches, start_tokens, rope_pos, eos_token_id, cfg, max_new_tokens,
                                 do_sample, temperature, generator, compute_dtype, cuda_graph)
    return tokens, num, caches


def shard_cache(cache: KVCache, group) -> KVCache:
    """This rank's contiguous context shard of a whole cache (leaves copied;
    `length` is the whole's): rows [rank * C / n, (rank + 1) * C / n) of the
    capacity C, which must divide the group's n ranks."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    cap = cache.k.shape[-2]
    assert cap % n == 0, f"cache capacity {cap} must divide the group's {n} ranks"
    c = cap // n

    def rows(t, axis):
        return None if t is None else t.narrow(axis, r * c, c).clone()

    return KVCache(rows(cache.k, -2), rows(cache.v, -2), rows(cache.k_scale, -1), rows(cache.v_scale, -1),
                   cache.length.clone())


@torch.inference_mode()
def generate_tp(
    lm: MoTForCausalLM, cache: KVCache, start_token, rope_pos, eos_token_id: int, cfg: LLMConfig, group,
    max_new_tokens: int = 100, do_sample: bool = False, temperature: float = 1.0,
    generator: Optional[torch.Generator] = None, compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Context-sharded generation (flash decoding across ranks; the port of
    g2vlm_tpu's `generate_tp`): `cache` is this rank's shard (`shard_cache`),
    the model whole on every rank, and every rank runs the same step, merging
    each layer's softmax statistics over `group`. Token for token equal to
    one-process `generate`. Sampling needs one generator state on every rank.
    Returns (tokens, num_generated, this rank's shard, extended in place)."""
    tokens, num = _generate_loop(lm, _batched(cache), start_token, rope_pos, eos_token_id, cfg, max_new_tokens,
                                 do_sample, temperature, generator, compute_dtype, False, group=group)
    return tokens[0], num[0], cache


@torch.inference_mode()
def generate_batched_dp(
    lm: MoTForCausalLM, caches: KVCache, start_tokens, rope_pos, eos_token_id: int, cfg: LLMConfig, group,
    max_new_tokens: int = 100, **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Data-parallel batched decoding: each rank of `group` advances its own
    sequences (`caches` with a leading batch axis, as `generate_batched`
    takes; every rank the same number) and the tokens and counts are
    all-gathered in rank order. Returns (tokens (B, max_new_tokens),
    num_generated (B,), this rank's caches) for the whole batch B."""
    from ..parallel.comm import gather_values

    tokens, num, caches = generate_batched(lm, caches, start_tokens, rope_pos, eos_token_id, cfg,
                                           max_new_tokens=max_new_tokens, **kwargs)
    return gather_values(tokens.contiguous(), group), gather_values(num.contiguous(), group), caches


def stack_caches(caches: Sequence[KVCache]) -> KVCache:
    """Single-sequence caches of one capacity -> the batched form."""
    return KVCache(*(None if ts[0] is None else torch.stack(ts) for ts in zip(*caches)))
