"""Operations and bytes of a recon call of the Kimi-VL decoder's configuration
(configs/g2vlm-kimivl-a3b-bf16.json), worked out from the inputs' shapes alone,
and the bounds of its MLA forward launches and of its expert products, read
the way work/counts.py reads K2's.

- Matrix products count the active experts only: per row and MoE layer the
  router, the 6 routed experts and the shared one; per row and layer the MLA
  projections (q_proj, kv_a_proj_with_mqa, kv_b_proj, o_proj).
- MLA attention: two products per query head over the visible pairs, QK^T at
  the QK head dim (192) and P V at the V head dim (128).
- The MLA forward's bound: the larger of its operations over the bf16 peak and
  its bytes over the memory rate, q and k (192 wide), v and out (128 wide)
  read or written once each in bf16, on the padded rows, one launch a layer.
- The experts' bound: the routed and shared SwiGLU products of every MoE
  layer over the real rows, against every expert's weights and the routed
  rows read once and written once, in bf16.
"""

from __future__ import annotations

from typing import Dict

from ..reference import kimivl, layout
from . import counts


def _row_flops(cfg: Dict) -> float:
    """Product operations a row takes in the decoder, all layers."""
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = 2.0 * (d * nh * dqk + d * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
                  + cfg["kv_lora_rank"] * nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) + nh * cfg["v_head_dim"] * d)
    dense = 2.0 * 3 * d * cfg["intermediate_size"]
    i = cfg["moe_intermediate_size"]
    sparse = 2.0 * (d * cfg["n_routed_experts"] + 3 * d * i * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    n_dense = cfg["first_k_dense_replace"]
    return cfg["num_hidden_layers"] * attn + n_dense * dense + (cfg["num_hidden_layers"] - n_dense) * sparse


def mla_bound_s(cfg: Dict, pairs: float, rows: int) -> float:
    """One MLA forward launch over `pairs` visible pairs on `rows` (padded) rows."""
    nh = cfg["num_attention_heads"]
    dqk, dv = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    flops = 2.0 * pairs * nh * (dqk + dv)
    n_bytes = 2.0 * rows * nh * (2 * dqk + 2 * dv)
    return counts.bound_s(n_bytes, flops)[0]


def moe_bound_s(cfg: Dict, rows: int) -> float:
    """The routed and shared expert products of every MoE layer over `rows` rows."""
    d, i, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    shared = cfg["n_shared_experts"]
    flops = 2.0 * 3 * d * i * rows * (k + shared)
    n_bytes = 2.0 * (3 * d * i * (cfg["n_routed_experts"] + shared) + 2 * rows * k * d + 2 * rows * d)
    return (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]) * counts.bound_s(n_bytes, flops)[0]


def recon_work(cfg: Dict, n: int, hp: int, wp: int) -> Dict[str, float]:
    """FLOPs of one call (active experts only), the bound of its MLA launches (one a layer) and
    of its expert products."""
    tc = kimivl.tower_cfg(cfg)
    lay = layout.recon_layout(n, hp, wp)
    pairs = lay.visible_pairs()
    rows = lay.seq_len
    nh = cfg["num_attention_heads"]
    attn = cfg["num_hidden_layers"] * 2.0 * pairs * nh * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                                                          + cfg["v_head_dim"])
    flops = (counts.dinov2_flops(tc, n, hp, wp) + rows * _row_flops(cfg) + attn + counts.heads_flops(tc, n, hp, wp))
    mla = cfg["num_hidden_layers"] * mla_bound_s(cfg, pairs, counts.round_up(rows, counts.SEQ_PAD))
    return {"flops": flops, "mla_bound_s": mla, "moe_bound_s": moe_bound_s(cfg, rows), "views": n}
