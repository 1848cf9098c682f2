"""The sparse-expert layer of the "mla_moe" decoder (Kimi-VL-A3B's DeepSeek-V3 MoE): the router,
the dispatch of each token to its experts, the experts' products and the combine.

Routing, as `MoEGate` of the published `modeling_deepseek.py` with `topk_method` "noaux_tc" and
one group: fp32 logits of the normed hidden state, scores sigmoid(logits), the top k experts chosen
on scores + `e_score_correction_bias` (the bias chooses, it never weighs), gate weights the
unbiased scores of the chosen k over their sum (+1e-20) times `routed_scaling_factor`.

Dispatch (`moe_experts`): the (token, slot) pairs sorted by expert, stably, so that each expert's
tokens are one contiguous slice; then one grouped product per weight over all the slices
(`torch._grouped_mm`, whose group ends stay on the device: no host sync, so a decode step that runs
it captures in a CUDA graph), SwiGLU between them, its output times the pair's gate weight (in fp32,
rounded once: the down projection is linear, so this is the weighted sum's term); then the rows
gathered back into (token, slot) order and summed over the slots (fp32 accumulation). No expert runs
on a token not routed to it and no weight is gathered per token. On the CPU the same sort feeds one
product per expert over its slice (the plain version, which reads the slice ends on the host).

Spans `moe.route` (router, top-k, sort; then the combine) and `moe.experts` (the routed and shared
products and the gate weights between them), and with the recorder on, the counters
`moe.tokens.l<layer>.max` (the tokens routed to the busiest expert of the layer, a device tensor
that the recorder reads when summarised) and `moe.tokens.l<layer>.mean` (tokens times k over the
experts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing


def route(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int, scaling: float,
          norm_topk_prob: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (T, D) -> (expert ids (T, k) int64, gate weights (T, k) fp32)."""
    scores = F.linear(h.float(), weight.float()).sigmoid()
    _, idx = torch.topk(scores + bias.float()[None], top_k, dim=-1, sorted=False)
    w = scores.gather(1, idx)
    if top_k > 1 and norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def _grouped(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor, counts: Optional[list]) -> torch.Tensor:
    """x (R, K) rows sorted by group, w (E, N, K): row block e times w[e]^T -> (R, N). `ends`
    (E,) int32 cumulative row counts on x's device; `counts` the same on the host (CPU path)."""
    if x.device.type == "cuda":
        return torch._grouped_mm(x, w.transpose(1, 2), offs=ends)
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for e, n in enumerate(counts):
        if n:
            out[start:start + n] = F.linear(x[start:start + n], w[e])
        start += n
    return out


def moe_experts(h: torch.Tensor, idx: torch.Tensor, gate_w: torch.Tensor, gate_up: torch.Tensor,
                down: torch.Tensor, layer: int = 0) -> torch.Tensor:
    """The routed experts' sum for each token: h (T, D) in the compute dtype, idx / gate_w (T, k)
    from `route`, gate_up (E, 2I, D) (each expert's gate rows, then its up rows), down (E, D, I).
    Returns (T, D) in h's dtype."""
    t, k = idx.shape
    e = gate_up.shape[0]
    dt = h.dtype
    with tracing.span("moe.route"):
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)  # (T k,) pairs grouped by expert, each group in token order
        # scatter_add, not bincount: bincount on a CUDA tensor reads its maximum on the host
        per_expert = torch.zeros(e, dtype=torch.int64, device=h.device).scatter_add_(0, flat, torch.ones_like(flat))
        ends = torch.cumsum(per_expert, 0).to(torch.int32)
        counts = per_expert.tolist() if h.device.type != "cuda" else None
        if tracing.recording() and not (h.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            tracing.count(f"moe.tokens.l{layer}.max", per_expert.max())  # on the device: no sync
            tracing.count(f"moe.tokens.l{layer}.mean", t * k / e)
        xs = h[order // k]
    with tracing.span("moe.experts"):
        gu = _grouped(xs, gate_up.to(dt), ends, counts)
        i = gu.shape[1] // 2
        act = (F.silu(gu[:, :i]) * gu[:, i:]).mul_(gate_w.reshape(-1)[order, None])
        ys = _grouped(act, down.to(dt), ends, counts)
    with tracing.span("moe.route"):
        back = torch.empty_like(order)
        back[order] = torch.arange(order.numel(), device=order.device)  # sorted row of each (token, slot)
        return ys.index_select(0, back).view(t, k, -1).sum(1)
