"""Plain PyTorch reference of G2VLM with Kimi-VL-A3B's language model as its decoder
(`benchmark/configs/g2vlm-kimivl-a3b-bf16.json`): the recon forward and the chat forward of
reference/forward.py, with the decoder replaced by the DeepSeek-V3 block of
moonshotai/Kimi-VL-A3B-Instruct's `modeling_deepseek.py` (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct,
`config.json` `text_config`), written out here in float32 from the published description:

- MLA without a q-LoRA: q = q_proj(h) per head [nope 128 | rope 64]; [c | k_pe] =
  kv_a_proj_with_mqa(h), c normed by kv_a_layernorm; [k_nope | v] = kv_b_proj(c) per head; RoPE
  (theta `rope_theta`) on q's and k_pe's rope columns in the interleaved-pair form (the pairs
  split into evens and odds, then rotated by halves, as `apply_rotary_pos_emb`); k_pe shared by
  the heads; softmax scale (nope + rope)^-0.5; o_proj. Every head's keys and values
  materialised, masks over blocks of query rows, no cache;
- the first `first_k_dense_replace` layers a SwiGLU MLP, the rest per token: fp32 router logits,
  scores sigmoid(logits), the top `num_experts_per_tok` experts chosen on scores +
  e_score_correction_bias, weights the unbiased scores of the chosen over their sum (+1e-20)
  times `routed_scaling_factor`; the routed experts' weighted SwiGLU outputs plus the shared
  SwiGLU (`n_shared_experts` times the expert width).

Near ties (`follow`): where the system's k experts of a row differ from the reference's own, and
each of them has a biased score within `TIE` of the reference's k-th, the reference routes that row
as the system did (each side's choice is then the other's, up to rounding) and weighs the choice
with its own unbiased scores. Without that, a choice that rounding flips moves the row's hidden
state, which moves the next layers' scores, and the two sides drift apart through the 26 layers
whatever the precision. A choice outside `TIE` of the k-th is the reference's own, so a router
that chooses by another rule is not followed.

It imports nothing of the system under test, and turns TF32 off (`model.strict_fp32`). Departures from Kimi-VL (the configuration's
`assumed`): the towers and heads are G2VLM's (DINOv2, the Qwen2-VL ViT, Pi3) at the language
model's width, not MoonViT; positions are 1-D (row i of a sequence at position i); the attention
masks are G2VLM's (the DINOv2 span bidirectional, the rest causal).

The weights dict may hold the drawn values in bf16 (the only copy that fits the card beside the
activations): `Fp32` hands each leaf out as float32 where it is used, bit-identical to a float32
copy of the same draws. `quant` fake-quantises both operands of every product, as model.Ref does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import layout, model, preprocess

Tensor = torch.Tensor
PREFIX = "language_model.model."
# Biased scores this close to the k-th count as tied: above the largest shift that rounding alone
# gives in the first MoE layer of the cell recon-32v-kimivl (0.0108 on an H100: bf16 against this).
TIE = 2.0 ** -6


class Fp32(dict):
    """A weights dict whose leaves read as float32."""

    def __getitem__(self, key):
        return super().__getitem__(key).float()


def tower_cfg(cfg: Dict) -> Dict:
    """The configuration as model.py's tower and head functions read it: an `llm` group with the
    width they take (and a zero-layer MoT decoder, whose leaves param_shapes then leaves out)."""
    llm = {k: cfg[k] for k in ("hidden_size", "vocab_size", "num_attention_heads", "num_key_value_heads",
                               "intermediate_size")}
    return dict(cfg, llm=dict(llm, num_hidden_layers=0))


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight and its shape, under the published key names (the experts one leaf each:
    `...mlp.experts.{j}.gate_proj.weight`, ...), so that benchmark/weights.py reads each leaf's
    fan-in from its own shape."""
    s = {k: v for k, v in model.param_shapes(tower_cfg(cfg)).items() if not k.startswith("language_model.")}
    d, v, nh = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    s[PREFIX + "embed_tokens.weight"] = (v, d)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{PREFIX}layers.{i}."
        s[p + "input_layernorm.weight"] = (d,)
        s[p + "post_attention_layernorm.weight"] = (d,)
        s[p + "self_attn.q_proj.weight"] = (nh * (dn + dr), d)
        s[p + "self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, d)
        s[p + "self_attn.kv_a_layernorm.weight"] = (r,)
        s[p + "self_attn.kv_b_proj.weight"] = (nh * (dn + dv), r)
        s[p + "self_attn.o_proj.weight"] = (d, nh * dv)

        def swiglu(q, width):
            s[q + "gate_proj.weight"] = (width, d)
            s[q + "up_proj.weight"] = (width, d)
            s[q + "down_proj.weight"] = (d, width)

        if i < cfg["first_k_dense_replace"]:
            swiglu(p + "mlp.", cfg["intermediate_size"])
            continue
        e = cfg["n_routed_experts"]
        s[p + "mlp.gate.weight"] = (e, d)
        s[p + "mlp.gate.e_score_correction_bias"] = (e,)
        for j in range(e):
            swiglu(f"{p}mlp.experts.{j}.", cfg["moe_intermediate_size"])
        swiglu(p + "mlp.shared_experts.", cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    s[PREFIX + "norm.weight"] = (d,)
    s["language_model.lm_head.weight"] = (v, d)
    return s


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (S, ..., R) interleaved pairs, pos (S,) -> roped, in the split order (evens, then odds)."""
    dim = x.shape[-1]
    inv = torch.from_numpy(1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))).to(x.device)
    ang = pos.float()[:, None] * torch.cat([inv, inv])[None]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (dim,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x = x.unflatten(-1, (dim // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + model.rotate_half(x) * sin


def route(r: model.Ref, h: Tensor, p: str, follow: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per token: (expert ids (T, k), gate weights (T, k)), as stated in the module docstring;
    `follow` (T', k), T' >= T, the system's choices, followed at near ties."""
    cfg = r.cfg
    scores = torch.sigmoid(r.lin(h, p + "mlp.gate", bias=False))
    biased = scores + r.W[p + "mlp.gate.e_score_correction_bias"][None]
    top, idx = torch.topk(biased, cfg["num_experts_per_tok"], -1)
    if follow is not None:
        f = follow[:h.shape[0]].to(idx.device, torch.int64)
        tied = (biased.gather(1, f) >= top[:, -1:] - TIE).all(-1, keepdim=True)
        idx = torch.where(tied, f, idx)
    if getattr(r, "record", None) is not None:
        r.record.append((biased, idx))
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def swiglu(r: model.Ref, h: Tensor, q: str) -> Tensor:
    return r.lin(F.silu(r.lin(h, q + "gate_proj", False)) * r.lin(h, q + "up_proj", False), q + "down_proj", False)


def moe(r: model.Ref, h: Tensor, p: str, follow: Optional[Tensor] = None) -> Tensor:
    idx, w = route(r, h, p, follow)
    out = swiglu(r, h, p + "mlp.shared_experts.")
    for j in range(r.cfg["n_routed_experts"]):
        tok, slot = (idx == j).nonzero(as_tuple=True)
        if len(tok):
            out[tok] += w[tok, slot, None] * swiglu(r, h[tok], f"{p}mlp.experts.{j}.")
    return out


def decoder(r: model.Ref, x: Tensor, lay: layout.Layout, block: int = 1024,
            follow: Optional[Sequence[Tensor]] = None) -> Tensor:
    """The decoder over a whole sequence (S, D) laid out by `lay` -> the final normed hidden states;
    `follow` the system's choices of each MoE layer in turn (see `route`)."""
    cfg = r.cfg
    s = x.shape[0]
    nh, dn, dr, dv, rank = (cfg[k] for k in ("num_attention_heads", "qk_nope_head_dim", "qk_rope_head_dim",
                                             "v_head_dim", "kv_lora_rank"))
    eps = cfg["rms_norm_eps"]
    dev = x.device
    info = [torch.as_tensor(f, device=dev) for f in lay.info]
    pos = info[3]
    for i in range(cfg["num_hidden_layers"]):
        p = f"{PREFIX}layers.{i}."
        h = r.rms(x, p + "input_layernorm", eps)
        q = r.lin(h, p + "self_attn.q_proj", False).view(s, nh, dn + dr)
        ckv = r.lin(h, p + "self_attn.kv_a_proj_with_mqa", False)
        c = r.rms(ckv[:, :rank], p + "self_attn.kv_a_layernorm", eps)
        kv = r.lin(c, p + "self_attn.kv_b_proj", False).view(s, nh, dn + dv)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg["rope_theta"])], -1).transpose(0, 1)[None]
        k_pe = rope(ckv[:, None, rank:], pos, cfg["rope_theta"]).expand(s, nh, dr)
        k = torch.cat([kv[..., :dn], k_pe], -1).transpose(0, 1)[None]
        v = kv[..., dn:].transpose(0, 1)[None]
        a = torch.cat([
            r.attend(q[:, :, q0:q0 + block], k, v, layout.visible([f[q0:q0 + block] for f in info], info))[0]
            for q0 in range(0, s, block)
        ], 1).transpose(0, 1).reshape(s, nh * dv)
        x = x + r.lin(a, p + "self_attn.o_proj", False)
        h = r.rms(x, p + "post_attention_layernorm", eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(r, h, p + "mlp.")
        else:
            x = x + moe(r, h, p, None if follow is None else follow[i - cfg["first_k_dense_replace"]])
    return r.rms(x, PREFIX + "norm", eps)


def _ref(W: Dict[str, Tensor], cfg: Dict, quant: Optional[torch.dtype], record: Optional[list] = None) -> model.Ref:
    model.strict_fp32()
    r = model.Ref(W if isinstance(W, Fp32) else Fp32(W), tower_cfg(cfg), quant)
    r.record = record
    return r


def recon(W: Dict[str, Tensor], cfg: Dict, frames: Tensor, new_width: int,
          quant: Optional[torch.dtype] = None, follow: Optional[Sequence[Tensor]] = None,
          record: Optional[list] = None) -> Dict[str, Tensor]:
    """frames (N, H0, W0, 3) uint8 on the reference's device -> points, local_points,
    global_points, camera_poses. `follow`: the system's choices of each MoE layer, followed at
    near ties (`route`); `record`, a list, gets each MoE layer's (biased scores, choices)."""
    r = _ref(W, cfg, quant, record)
    p = cfg["dino"]["patch_size"]
    views = preprocess.recon_views(frames, new_width, p)
    n, _, h, w = views.shape
    lay = layout.recon_layout(n, h // p, w // p)
    emb = r.lin(model.dinov2(r, views).reshape(-1, cfg["dino"]["hidden_size"]), "dino2llm")
    hidden = decoder(r, model.embed_sequence(r, lay, emb, None, frames.device), lay, follow=follow)
    dino = hidden[torch.as_tensor(lay.dino_indexes, device=frames.device)].reshape(n, -1, hidden.shape[-1])
    return model.pi3_heads(r, dino, (h, w))


def chat_logits(W: Dict[str, Tensor], cfg: Dict, frames: Sequence[np.ndarray], question: str,
                served: Sequence[int], device, quant: Optional[torch.dtype] = None,
                new_width: int = 518) -> Tensor:
    """One full forward over the prompt and the served tokens: the logits (len(served), V) at the
    start token and at every served token but the last (row i chose served[i])."""
    r = _ref(W, cfg, quant)
    p = cfg["dino"]["patch_size"]
    views = torch.as_tensor(preprocess.chat_views(frames, new_width, p), device=device)
    n, _, h, w = views.shape
    rows = [preprocess.vit_rows(f) for f in frames]
    lay = layout.chat_layout(n, h // p, w // p, [g for _, g in rows], question, served)
    dino = r.lin(model.dinov2(r, views).reshape(-1, cfg["dino"]["hidden_size"]), "dino2llm")
    vit = torch.cat([model.vit(r, torch.as_tensor(x, device=device), g) for x, g in rows])
    hidden = decoder(r, model.embed_sequence(r, lay, dino, vit, device), lay)
    return r.lin(hidden[lay.prompt_len:], "language_model.lm_head", bias=False)
