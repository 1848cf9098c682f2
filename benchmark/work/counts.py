"""Operations and bytes that a recon call and a chat request need, worked out
from the inputs' shapes alone, and the roofline bounds of the attention
kernels. Whatever implements the work, these are read the same way.

- Attention is counted over the pairs that the mask makes visible
  (`reference.layout.Layout.visible_pairs`), two products of 2 * pairs * head_dim
  operations per query head.
- Matrix products are counted as the routing needs them: the recon prefill
  (GEO_MAIN) runs the geometry expert on every row and the base expert again
  on the text rows; the chat prefill (SPLIT) runs one expert per row; a
  decode step runs the base expert on one row.
- A kernel's bound is the larger of its operations over the bf16 peak and its
  bytes over the memory rate: q and out read or written once each, K and V
  once each, in bf16 (the bound arithmetic of chip_smoke.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..reference import layout

# published peaks of one H100 SXM (dense, no sparsity)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SEQ_PAD = 256  # the pipeline pads a prefill to a multiple of this many rows
VIT_PAD = 8  # and the ViT's packed patch rows to a multiple of this
VIT_ROWS = 2916  # patch rows of a chat image: 768x768 rounded to 756x756, 54 x 54 patches


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bound_s(n_bytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, what bounds them)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def attention_bound_s(pairs: float, heads: int, d: int, n_products: int, rows_q: int, rows_kv: int,
                      kv_heads: int, n_q_shaped: int, n_kv_shaped: int, stat_rows: int = 0) -> float:
    """`n_products` products of 2 * pairs * d operations per query head;
    `n_q_shaped` bf16 tensors of q's shape and `n_kv_shaped` of k's read or
    written once each, and `stat_rows` fp32 row statistics."""
    flops = n_products * 2.0 * pairs * d * heads
    n_bytes = 2.0 * d * (n_q_shaped * rows_q * heads + n_kv_shaped * rows_kv * kv_heads) + 4.0 * stat_rows
    return bound_s(n_bytes, flops)[0]


def forward_bound_s(pairs, heads, d, rows, kv_heads) -> float:
    """K2: the segment forward without lse."""
    return attention_bound_s(pairs, heads, d, 2, rows, rows, kv_heads, 2, 2)


def backward_bounds_s(pairs, heads, d, rows, kv_heads) -> Tuple[float, float]:
    """K5: (dq: its own 3 products; dkv: its own 4)."""
    dq = attention_bound_s(pairs, heads, d, 3, rows, rows, kv_heads, 3, 2, stat_rows=2 * rows * heads)
    dkv = attention_bound_s(pairs, heads, d, 4, rows, rows, kv_heads, 2, 4, stat_rows=2 * rows * heads)
    return dq, dkv


# ---------------------------------------------------------------------------
# the towers and the heads
# ---------------------------------------------------------------------------


def _block_flops(rows: int, d: int, mlp: int) -> float:
    """q, k, v, out projections and a two-matrix MLP on `rows` rows."""
    return 2.0 * rows * d * (4 * d + 2 * mlp)


def dinov2_flops(cfg: Dict, n: int, hp: int, wp: int) -> float:
    c = cfg["dino"]
    d, p = c["hidden_size"], c["patch_size"]
    t = 1 + c["num_register_tokens"] + hp * wp
    per_layer = _block_flops(n * t, d, d * c["mlp_ratio"]) + 4.0 * n * t * t * d
    embed = 2.0 * n * hp * wp * 3 * p * p * d
    return embed + c["num_hidden_layers"] * per_layer + 2.0 * n * hp * wp * d * cfg["llm"]["hidden_size"]


def vit_flops(cfg: Dict, n_images: int, rows: int = VIT_ROWS) -> float:
    c = cfg["vit"]
    d = c["embed_dim"]
    p, tps = c["patch_size"], c["temporal_patch_size"]
    per_layer = _block_flops(n_images * rows, d, int(d * c["mlp_ratio"])) + 4.0 * n_images * rows * rows * d
    merge = 4 * d
    merger = 2.0 * n_images * rows // 4 * merge * (merge + c["hidden_size"])
    return 2.0 * n_images * rows * 3 * tps * p * p * d + c["depth"] * per_layer + merger


def heads_flops(cfg: Dict, n: int, hp: int, wp: int) -> float:
    c = cfg["pi3"]
    d = cfg["llm"]["hidden_size"]
    hw = hp * wp
    rows = n * hw
    mlp = int(d * c["mlp_ratio"])
    block = _block_flops(rows, d, mlp) + 4.0 * n * hw * hw * d
    cross = 2.0 * rows * d * 2 * d + 2.0 * hw * d * 2 * d + 4.0 * n * hw * hw * d
    pt, cam = c["point_out_dim"], c["camera_out_dim"]
    p = cfg["dino"]["patch_size"]
    out = 2.0 * rows * d * (2 * pt + cam) + 2 * 2.0 * rows * pt * 3 * p * p
    camera = 2.0 * rows * cam * cam * 6 + 2.0 * n * cam * (2 * cam + 12)
    n_dec = 3 if cfg.get("use_global_points", True) else 2
    return c["depth"] * (n_dec * block + (cross if n_dec == 3 else 0)) + out + camera


def _decoder_rows_flops(cfg: Dict, rows: int) -> float:
    c = cfg["llm"]
    d = c["hidden_size"]
    kv = c["num_key_value_heads"] * (d // c["num_attention_heads"])
    return c["num_hidden_layers"] * 2.0 * rows * d * (2 * d + 2 * kv + 3 * c["intermediate_size"])


def _decoder_attention_flops(cfg: Dict, pairs: float) -> float:
    c = cfg["llm"]
    return c["num_hidden_layers"] * 4.0 * pairs * c["hidden_size"]


# ---------------------------------------------------------------------------
# a recon call and a chat request
# ---------------------------------------------------------------------------


def recon_work(cfg: Dict, n: int, hp: int, wp: int) -> Dict[str, float]:
    """FLOPs of one call and the bound of its K2 launches (one per decoder layer)."""
    c = cfg["llm"]
    lay = layout.recon_layout(n, hp, wp)
    pairs = lay.visible_pairs()
    rows = lay.seq_len
    flops = (dinov2_flops(cfg, n, hp, wp) + _decoder_rows_flops(cfg, rows + len(lay.text_ids))
             + _decoder_attention_flops(cfg, pairs) + heads_flops(cfg, n, hp, wp))
    hd = c["hidden_size"] // c["num_attention_heads"]
    k2 = c["num_hidden_layers"] * forward_bound_s(pairs, c["num_attention_heads"], hd, round_up(rows, SEQ_PAD),
                                                  c["num_key_value_heads"])
    return {"flops": flops, "k2_bound_s": k2, "views": n}


def chat_work(cfg: Dict, n: int, hp: int, wp: int, words: int, tokens: int) -> Dict[str, float]:
    """FLOPs of one request (`words` question words, `tokens` decode steps) and
    the bound of its K2 launches: the ViT's (one per block, at head dim 80) and
    the prefill's (one per decoder layer)."""
    c, v = cfg["llm"], cfg["vit"]
    d, nh = c["hidden_size"], c["num_attention_heads"]
    hd = d // nh
    lay = layout.chat_layout(n, hp, wp, [(1, 54, 54)] * n, " ".join(["w"] * words))
    s = lay.seq_len
    pairs = lay.visible_pairs()
    prefill = (dinov2_flops(cfg, n, hp, wp) + vit_flops(cfg, n) + _decoder_rows_flops(cfg, s)
               + _decoder_attention_flops(cfg, pairs))
    # step i attends over the prompt, the start token and i earlier tokens
    cached = tokens * s + tokens * (tokens + 1) / 2
    decode = (_decoder_rows_flops(cfg, tokens) + _decoder_attention_flops(cfg, cached)
              + 2.0 * tokens * d * c["vocab_size"])
    vh = v["embed_dim"] // v["num_heads"]
    vit_rows = round_up(n * VIT_ROWS, VIT_PAD)
    k2 = (v["depth"] * forward_bound_s(n * VIT_ROWS ** 2, v["num_heads"], vh, vit_rows, v["num_heads"])
          + c["num_hidden_layers"] * forward_bound_s(pairs, nh, hd, round_up(s, SEQ_PAD), c["num_key_value_heads"]))
    return {"flops": prefill + decode, "k2_bound_s": k2, "views": n, "tokens": tokens}
