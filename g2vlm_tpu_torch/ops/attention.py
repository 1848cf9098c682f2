"""Plain PyTorch attention (port of g2vlm_tpu/ops/attention.py).

These are the CPU path and the test oracle of the CUDA kernels in
ops/flash_attention.py; the dispatch by device lives in the kernels' wrappers
there (CUDA tensors launch the kernel, CPU tensors take these functions).
Every form computes in float32 and returns the input dtype.
`segment_attention` chooses among the segment kernels by the caller's
serving options. `cache_attention` is a decode step's token against its cache.

Layout: batched q (..., S, H, D); packed q (S_q, H, D) against k, v
(S_kv, KVH, D) with GQA, query head h reading KV head h // (H / KVH).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .masks import TokenInfo, make_segment_mask

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def dense_attention(
    q: torch.Tensor,  # (..., S_q, H, D)
    k: torch.Tensor,  # (..., S_kv, H, D)
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # broadcastable to (..., H, S_q, S_kv)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain batched MHA with an optional boolean mask; fp32 softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", probs, v.float())
    return out.to(v.dtype)


def segment_attention_dense(q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None):
    """Materialized-mask segment attention; rows with no visible key are 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_q, h, d = q.shape
    kvh = k.shape[1]
    mask = make_segment_mask(q_info, kv_info)  # (S_q, S_kv)
    qg = q.float().reshape(s_q, kvh, h // kvh, d)
    logits = torch.einsum("qngd,knd->qngk", qg, k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(-1)[:, None, None, None]
    out = torch.einsum("qngk,knd->qngd", probs, v.float())
    return out.reshape(q.shape).to(v.dtype)


def segment_attention_chunked(
    q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None, kv_chunk: int = 2048,
    return_lse: bool = False,
):
    """Online-softmax segment attention over KV chunks: never materializes the
    (S_q, S_kv) logits, so it serves as the plain version at the 25k-token
    prefill (a dense fp32 logit tensor there would be 30 GB). Rows with no
    visible key are 0. With return_lse also the rows' log-sum-exp (H, S_q),
    -1e30 for a row that sees no key. Computes in fp32 (fp64 inputs in fp64)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    s_q, h, d = q.shape
    s_kv, kvh, _ = k.shape
    dv = v.shape[-1]  # the MLA forward's values are narrower than its queries and keys
    g = h // kvh
    # (KVH, G*S_q, D): the G query heads of a KV head share each chunk's K/V
    qh = q.to(ct).reshape(s_q, kvh, g, d).permute(1, 2, 0, 3).reshape(kvh, g * s_q, d)
    m = torch.full((kvh, g * s_q), float("-inf"), device=q.device, dtype=ct)
    l = torch.zeros((kvh, g * s_q), device=q.device, dtype=ct)
    acc = torch.zeros((kvh, g * s_q, dv), device=q.device, dtype=ct)
    for c0 in range(0, s_kv, kv_chunk):
        kb = k[c0 : c0 + kv_chunk].to(ct).transpose(0, 1)  # (KVH, T, D)
        vb = v[c0 : c0 + kv_chunk].to(ct).transpose(0, 1)
        t = kb.shape[1]
        mask = make_segment_mask(q_info, kv_info.slice(c0, t)).repeat(g, 1)  # (G*S_q, T)
        logits = torch.matmul(qh, kb.transpose(1, 2)) * scale
        logits = logits.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, logits.amax(-1))
        # a row with nothing visible yet shifts by 0, so exp(-inf) stays 0
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        p = torch.exp(logits - m_use[..., None])
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.reshape(kvh, g, s_q, dv).permute(2, 0, 1, 3).reshape(s_q, h, dv).to(v.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, -1e30))
    return out, lse.reshape(h, s_q)


INT8_MIN_PAIRS = 4096 * 4096  # the int8 QK^T pays off on large prefill tiles only


def segment_attention(
    q, k, v, q_info: TokenInfo, kv_info: TokenInfo, scale=None, impl: str = "auto", pipelined: bool = False,
    plan=None,
):
    """Packed segment-masked GQA attention by the serving options, with the
    rules of g2vlm_tpu's `segment_attention`: impl "int8" takes the int8-QK
    kernel only when S_q * S_kv >= 4096^2 (small phases take the normal
    rule); everything else takes the segment kernel, in the two-stage
    schedule when `pipelined`. On the card every size takes a kernel: the port
    has no dense or chunked path there, so a call of a few hundred rows costs
    about what its tile codes cost on the host. `plan` is the caller's
    `flash_attention.segment_plan(q_info, kv_info)`, made once for the layers
    of a forward; without it each call makes its own."""
    from . import flash_attention as fa

    if impl not in ("auto", "int8"):
        raise ValueError(f"unknown attention impl: {impl}")
    if impl == "int8" and q.shape[0] * k.shape[0] >= INT8_MIN_PAIRS:
        return fa.flash_segment_attention_int8(q, k, v, q_info, kv_info, scale, plan=plan)
    return fa.flash_segment_attention(q, k, v, q_info, kv_info, scale, pipelined=pipelined, plan=plan)


def self_attender(info: TokenInfo, impl: str = "auto", pipelined: bool = False):
    """attend(q, k, v) for the layers of one forward, which all attend over
    the same packed sequence: `segment_attention` with the kernels' plan
    (packed metadata and tile codes) made here, once."""
    from . import flash_attention as fa

    plan = fa.segment_plan(info, info)

    def attend(q, k, v):
        return segment_attention(q, k, v, info, info, impl=impl, pipelined=pipelined, plan=plan)

    return attend


def cache_attention(q, k_all, v_all, k_scale, v_scale, visible, hd, k_self, v_self, group=None, self_here=None):
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
    acc = probs_times_values(pv, v_all.float()) + p_self[..., None] * v_self[:, :, None, :]
    if group is not None:
        dist.all_reduce(l, group=group)
        dist.all_reduce(acc, group=group)
    return acc / l.clamp_min(1e-30)[..., None]


PV_SPLIT = 256  # cache rows per partial product of P.V


def probs_times_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, KVH, G, C) @ v (B, KVH, C, HD) -> (B, KVH, G, HD). A product of G
    = 6 rows with a reduction over ~50k cache rows: as one matrix product the
    library walks the whole reduction in one block per head (1.4 ms per layer
    on an H100, most of a decode step), so the cache axis is cut into slices
    of PV_SPLIT rows (and a shorter last one), each a small product of its
    own, and the partial results are summed."""
    c = p.shape[-1]
    n = c // PV_SPLIT
    if n < 2:
        return torch.matmul(p, v)
    whole = n * PV_SPLIT
    parts = torch.matmul(p[..., :whole].unflatten(-1, (n, PV_SPLIT)).transpose(2, 3),
                         v[:, :, :whole].unflatten(2, (n, PV_SPLIT)))
    out = parts.sum(2)
    return out if whole == c else out + torch.matmul(p[..., whole:], v[:, :, whole:])
