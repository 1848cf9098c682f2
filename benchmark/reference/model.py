"""Plain PyTorch reference of G2VLM-2B-MoT (arXiv:2511.21688): the recon
forward (DINOv2 with registers, dino2llm, the Mixture-of-Transformers
Qwen2-VL decoder, the Pi3 heads) and the chat forward (the Qwen2-VL ViT,
DINOv2, the decoder over the prompt and the served tokens, the LM head).

Functions over a flat state dict `W` (name -> float32 tensor) under the
checkpoint's key space (`language_model.`, `dino_model.`, `dino2llm.`,
`point_decoder.`, ..., `vit_model.`), and a configuration dict as
`benchmark/configs/<name>.json` holds it. It imports nothing of the system
under test: every layer is written out here in float32, with materialised
attention masks over blocks of query rows, no cache and no kernels. Each row
of the decoder runs its own expert (geometry rows the `_moe_geo` weights with
LayerScale, every other row the base weights), which is what every routing
of the program (GEO_MAIN, SPLIT, MIXED) computes.

`quant`, a float8 dtype or None, fake-quantises both operands of every
matrix product to that format with one scale per tensor: the lower-precision
control of the comparison.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layout import Layout, visible

Tensor = torch.Tensor
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_fp32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the configuration and its shape, in the checkpoint's key space."""
    s: Dict[str, Tuple[int, ...]] = {}

    def lin(name, i, o, bias=True):
        s[name + ".weight"] = (o, i)
        if bias:
            s[name + ".bias"] = (o,)

    def ln(name, d):
        s[name + ".weight"] = (d,)
        s[name + ".bias"] = (d,)

    llm, dino, vit, pi3 = cfg["llm"], cfg["dino"], cfg["vit"], cfg["pi3"]
    d, v = llm["hidden_size"], llm["vocab_size"]
    hd = d // llm["num_attention_heads"]
    kv = llm["num_key_value_heads"] * hd
    p = "language_model.model."
    s[p + "embed_tokens.weight"] = (v, d)
    for i in range(llm["num_hidden_layers"]):
        q = f"{p}layers.{i}."
        for sfx in ("", "_moe_geo"):
            s[q + "input_layernorm" + sfx + ".weight"] = (d,)
            lin(q + "self_attn.q_proj" + sfx, d, d)
            lin(q + "self_attn.k_proj" + sfx, d, kv)
            lin(q + "self_attn.v_proj" + sfx, d, kv)
            lin(q + "self_attn.o_proj" + sfx, d, d, bias=False)
            s[q + "self_attn.q_norm" + sfx + ".weight"] = (hd,)
            s[q + "self_attn.k_norm" + sfx + ".weight"] = (hd,)
            s[q + "post_attention_layernorm" + sfx + ".weight"] = (d,)
        for m in ("mlp", "mlp_moe_geo"):
            lin(f"{q}{m}.gate_proj", d, llm["intermediate_size"], bias=False)
            lin(f"{q}{m}.up_proj", d, llm["intermediate_size"], bias=False)
            lin(f"{q}{m}.down_proj", llm["intermediate_size"], d, bias=False)
        s[q + "ls1.gamma"] = (d,)
        s[q + "ls2.gamma"] = (d,)
    s[p + "norm.weight"] = (d,)
    s[p + "norm_moe_geo.weight"] = (d,)
    s["language_model.lm_head.weight"] = (v, d)

    dd, ps = dino["hidden_size"], dino["patch_size"]
    n_side = dino["image_size"] // ps
    e = "dino_model.embeddings."
    s[e + "cls_token"] = (1, 1, dd)
    s[e + "mask_token"] = (1, dd)
    s[e + "register_tokens"] = (1, dino["num_register_tokens"], dd)
    s[e + "position_embeddings"] = (1, n_side * n_side + 1, dd)
    s[e + "patch_embeddings.projection.weight"] = (dd, 3, ps, ps)
    s[e + "patch_embeddings.projection.bias"] = (dd,)
    for i in range(dino["num_hidden_layers"]):
        q = f"dino_model.encoder.layer.{i}."
        ln(q + "norm1", dd)
        for n in ("query", "key", "value"):
            lin(q + "attention.attention." + n, dd, dd)
        lin(q + "attention.output.dense", dd, dd)
        s[q + "layer_scale1.lambda1"] = (dd,)
        ln(q + "norm2", dd)
        lin(q + "mlp.fc1", dd, dd * dino["mlp_ratio"])
        lin(q + "mlp.fc2", dd * dino["mlp_ratio"], dd)
        s[q + "layer_scale2.lambda1"] = (dd,)
    ln("dino_model.layernorm", dd)
    lin("dino2llm", dd, d)

    hidden = int(d * pi3["mlp_ratio"])

    def decoder(name, out_dim, cross=False):
        for i in range(pi3["depth"]):
            q = f"{name}.blocks.{i}."
            ln(q + "norm1", d)
            lin(q + "attn.qkv", d, 3 * d)
            lin(q + "attn.proj", d, d)
            ln(q + "norm2", d)
            lin(q + "mlp.fc1", d, hidden)
            lin(q + "mlp.fc2", hidden, d)
            if cross:
                ln(q + "norm_y", d)
                for n in ("q_proj", "k_proj", "v_proj", "proj"):
                    lin(q + "cross_attn." + n, d, d)
                ln(q + "norm3", d)
        lin(name + ".linear_out", d, out_dim)

    pt, cam = pi3["point_out_dim"], pi3["camera_out_dim"]
    decoder("point_decoder", pt)
    lin("point_head.proj", pt, 3 * ps * ps)
    decoder("camera_decoder", cam)
    for i in range(2):
        for j in (1, 2, 3):
            lin(f"camera_head.res_conv.{i}.res_conv{j}", cam, cam)
    lin("camera_head.more_mlps.0", cam, cam)
    lin("camera_head.more_mlps.2", cam, cam)
    lin("camera_head.fc_t", cam, 3)
    lin("camera_head.fc_rot", cam, 9)
    if cfg.get("use_global_points", True):
        decoder("global_points_decoder", pt, cross=True)
        lin("global_point_head.proj", pt, 3 * ps * ps)

    if cfg.get("visual_und", True):
        ve, vp, tps = vit["embed_dim"], vit["patch_size"], vit["temporal_patch_size"]
        s["vit_model.patch_embed.proj.weight"] = (ve, 3, tps, vp, vp)
        for i in range(vit["depth"]):
            q = f"vit_model.blocks.{i}."
            ln(q + "norm1", ve)
            ln(q + "norm2", ve)
            lin(q + "attn.qkv", ve, 3 * ve)
            lin(q + "attn.proj", ve, ve)
            lin(q + "mlp.fc1", ve, int(ve * vit["mlp_ratio"]))
            lin(q + "mlp.fc2", int(ve * vit["mlp_ratio"]), ve)
        merge = ve * vit["spatial_merge_size"] ** 2
        ln("vit_model.merger.ln_q", ve)
        lin("vit_model.merger.mlp.0", merge, merge)
        lin("vit_model.merger.mlp.2", merge, vit["hidden_size"])
    return s


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class Ref:
    """The weights, the configuration and the precision of one reference run."""

    def __init__(self, W: Dict[str, Tensor], cfg: Dict, quant: Optional[torch.dtype] = None):
        self.W, self.cfg, self.quant = W, cfg, quant

    def q(self, t: Tensor) -> Tensor:
        if self.quant is None:
            return t
        scale = FP8_MAX[self.quant] / t.abs().amax().clamp_min(1e-30)
        return (t * scale).to(self.quant).float() / scale

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def lin(self, x: Tensor, name: str, bias: bool = True) -> Tensor:
        w = self.W[name + ".weight"]
        y = self.mm(x, w.reshape(w.shape[0], -1).t())
        return y + self.W[name + ".bias"] if bias else y

    def ln(self, x: Tensor, name: str, eps: float = 1e-6) -> Tensor:
        return F.layer_norm(x, x.shape[-1:], self.W[name + ".weight"], self.W[name + ".bias"], eps)

    def rms(self, x: Tensor, name: str, eps: float) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * self.W[name + ".weight"]

    def attend(self, q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """q (B, H, S, D), k / v (B, H, T, D), mask (S, T) bool or None -> (B, H, S, D);
        a row that sees no key gives 0."""
        logits = self.mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        if mask is not None:
            p = torch.nan_to_num(p, nan=0.0)
        return self.mm(p, v)


def rotate_half(x: Tensor) -> Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _resize(x: Tensor, out_hw, mode: str) -> Tensor:
    """Antialiased resize of (C, H, W) or (N, C, H, W), the height pass first."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    y = x.reshape(1, -1, h, w)
    if h != out_hw[0]:
        y = F.interpolate(y, size=(out_hw[0], w), mode=mode, align_corners=False, antialias=True)
    if w != out_hw[1]:
        y = F.interpolate(y, size=tuple(out_hw), mode=mode, align_corners=False, antialias=True)
    return y.reshape(*x.shape[:-2], *out_hw)


# ---------------------------------------------------------------------------
# DINOv2 with registers
# ---------------------------------------------------------------------------


def dinov2(r: Ref, images: Tensor) -> Tensor:
    """(N, 3, H, W) RESNET-normalised views -> patch tokens (N, hp*wp, D)."""
    cfg = r.cfg["dino"]
    W = r.W
    n, c, h, w = images.shape
    p = cfg["patch_size"]
    hp, wp = h // p, w // p
    e = "dino_model.embeddings."
    patches = images.reshape(n, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5).reshape(n, hp * wp, c * p * p)
    x = r.lin(patches, e + "patch_embeddings.projection")
    d = x.shape[-1]
    pos = W[e + "position_embeddings"].reshape(-1, d)
    side = cfg["image_size"] // p
    grid = pos[1:]
    if (hp, wp) != (side, side):
        grid = _resize(grid.reshape(side, side, d).permute(2, 0, 1), (hp, wp), "bicubic").permute(1, 2, 0)
    x = torch.cat([W[e + "cls_token"].reshape(1, 1, d).expand(n, 1, d), x], 1)
    x = x + torch.cat([pos[:1], grid.reshape(hp * wp, d)])[None]
    regs = W[e + "register_tokens"].reshape(1, -1, d).expand(n, -1, d)
    x = torch.cat([x[:, :1], regs, x[:, 1:]], 1)
    nh = cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        q = f"dino_model.encoder.layer.{i}."
        t = x.shape[1]
        h1 = r.ln(x, q + "norm1", eps)
        qkv = [r.lin(h1, q + "attention.attention." + k).reshape(n, t, nh, -1).transpose(1, 2)
               for k in ("query", "key", "value")]
        a = r.attend(*qkv).transpose(1, 2).reshape(n, t, d)
        x = x + r.lin(a, q + "attention.output.dense") * W[q + "layer_scale1.lambda1"]
        m = r.lin(F.gelu(r.lin(r.ln(x, q + "norm2", eps), q + "mlp.fc1")), q + "mlp.fc2")
        x = x + m * W[q + "layer_scale2.lambda1"]
    x = r.ln(x, "dino_model.layernorm", eps)
    return x[:, 1 + cfg["num_register_tokens"]:]


# ---------------------------------------------------------------------------
# the Mixture-of-Transformers decoder
# ---------------------------------------------------------------------------


def mrope(position_ids: Tensor, head_dim: int, theta: float, section) -> Tuple[Tensor, Tensor]:
    """(3, S) positions -> cos, sin (S, head_dim): channel blocks of `section`
    (twice over) take the t, h and w position in turn."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))
    inv = torch.from_numpy(np.concatenate([inv, inv])).to(position_ids.device)
    axis = torch.as_tensor(np.concatenate([[i % 3] * s for i, s in enumerate(list(section) * 2)]),
                           device=position_ids.device)
    ang = position_ids.float()[axis].t() * inv
    return torch.cos(ang), torch.sin(ang)


def decoder(r: Ref, x: Tensor, lay: Layout, block: int = 1024) -> Tensor:
    """The decoder over a whole sequence (S, D) laid out by `lay` -> the final
    normed hidden states (S, D)."""
    cfg = r.cfg["llm"]
    W = r.W
    dev = x.device
    s, d = x.shape
    nh, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    eps = cfg["rms_norm_eps"]
    geo = torch.as_tensor(lay.is_geo, device=dev)
    rows = {"": (~geo).nonzero()[:, 0], "_moe_geo": geo.nonzero()[:, 0]}
    cos, sin = mrope(torch.as_tensor(lay.position_ids, device=dev), hd, cfg["rope_theta"], cfg["mrope_section"])
    info = [torch.as_tensor(f, device=dev) for f in (lay.doc_id, lay.fn_id, lay.noise_id, lay.pos)]

    def expert(fn, t):
        out = None
        for sfx, idx in rows.items():
            if len(idx):
                y = fn(sfx, t[idx])
                out = t.new_zeros((s, y.shape[-1])) if out is None else out
                out[idx] = y
        return out

    for i in range(cfg["num_hidden_layers"]):
        p = f"language_model.model.layers.{i}."

        def attn_in(sfx, t):
            h = r.rms(t, p + "input_layernorm" + sfx, eps)
            return torch.cat([r.lin(h, p + f"self_attn.{n}_proj" + sfx) for n in "qkv"], -1)

        def qk_norm(sfx, t):
            q = t[:, : nh * hd].reshape(-1, nh, hd)
            k = t[:, nh * hd:].reshape(-1, kvh, hd)
            return torch.cat([r.rms(q, p + "self_attn.q_norm" + sfx, eps).flatten(1),
                              r.rms(k, p + "self_attn.k_norm" + sfx, eps).flatten(1)], -1)

        qkv = expert(attn_in, x)
        qk = expert(qk_norm, qkv[:, : (nh + kvh) * hd]) if cfg.get("qk_norm", True) else qkv[:, : (nh + kvh) * hd]
        q = qk[:, : nh * hd].reshape(s, nh, hd)
        k = qk[:, nh * hd:].reshape(s, kvh, hd)
        v = qkv[:, (nh + kvh) * hd:].reshape(s, kvh, hd)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        kx = k.repeat_interleave(nh // kvh, 1).transpose(0, 1)[None]
        vx = v.repeat_interleave(nh // kvh, 1).transpose(0, 1)[None]
        a = torch.cat([
            r.attend(q[q0:q0 + block].transpose(0, 1)[None], kx, vx,
                     visible([f[q0:q0 + block] for f in info], info))[0].transpose(0, 1)
            for q0 in range(0, s, block)
        ]).reshape(s, d)

        def attn_out(sfx, t):
            y = r.lin(t, p + "self_attn.o_proj" + sfx, bias=False)
            return y * W[p + "ls1.gamma"] if sfx else y

        x = x + expert(attn_out, a)

        def mlp(sfx, t):
            h = r.rms(t, p + "post_attention_layernorm" + sfx, eps)
            m = f"{p}mlp{sfx}."
            y = r.lin(F.silu(r.lin(h, m + "gate_proj", False)) * r.lin(h, m + "up_proj", False), m + "down_proj", False)
            return y * W[p + "ls2.gamma"] if sfx else y

        x = x + expert(mlp, x)
    return expert(lambda sfx, t: r.rms(t, "language_model.model.norm" + sfx, eps), x)


def embed_sequence(r: Ref, lay: Layout, dino_emb: Optional[Tensor], vit_emb: Optional[Tensor], dev) -> Tensor:
    d = r.cfg["llm"]["hidden_size"]
    x = torch.zeros((lay.seq_len, d), device=dev)
    x[torch.as_tensor(lay.text_indexes, device=dev)] = r.W["language_model.model.embed_tokens.weight"][
        torch.as_tensor(lay.text_ids, device=dev, dtype=torch.long)]
    if dino_emb is not None:
        x[torch.as_tensor(lay.dino_indexes, device=dev)] = dino_emb
    if vit_emb is not None:
        x[torch.as_tensor(lay.vit_indexes, device=dev)] = vit_emb
    return x


# ---------------------------------------------------------------------------
# the Pi3 heads
# ---------------------------------------------------------------------------


def rope2d(pos: Tensor, head_dim: int, freq: float) -> Tuple[Tensor, Tensor]:
    """(S, 2) (y, x) patch coordinates -> cos, sin (S, head_dim): a 1D RoPE of
    half the head on each axis."""
    half = head_dim // 2
    inv = 1.0 / (freq ** (np.arange(0, half, 2, dtype=np.float32) / half))
    inv = torch.from_numpy(np.concatenate([inv, inv])).to(pos.device)
    ang = torch.cat([pos[:, :1].float() * inv, pos[:, 1:].float() * inv], -1)
    return torch.cos(ang), torch.sin(ang)


def _rope_axial(t: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """t (B, H, S, D): rotate_half within the y half and the x half."""
    h = t.shape[-1] // 2
    rot = torch.cat([rotate_half(t[..., :h]), rotate_half(t[..., h:])], -1)
    return t * cos + rot * sin


def pi3_decoder(r: Ref, name: str, x: Tensor, pos: Tensor, ctx: Optional[Tensor] = None) -> Tensor:
    """x (N, hw, D) -> (N, hw, out_dim); `ctx` (1, hw, D): frame 0 for the cross decoder."""
    cfg = r.cfg["pi3"]
    nh, eps = cfg["num_heads"], cfg["layer_norm_eps"]
    n, t, d = x.shape
    hd = d // nh
    cos, sin = rope2d(pos, hd, cfg["rope_freq"])

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], nh, hd).transpose(1, 2)

    for i in range(cfg["depth"]):
        p = f"{name}.blocks.{i}."
        qq, kk, vv = r.lin(r.ln(x, p + "norm1", eps), p + "attn.qkv").split(d, -1)
        a = r.attend(_rope_axial(heads(qq), cos, sin), _rope_axial(heads(kk), cos, sin), heads(vv))
        x = x + r.lin(a.transpose(1, 2).reshape(n, t, d), p + "attn.proj")
        if ctx is not None:
            y = r.ln(ctx, p + "norm_y", eps)
            h = r.ln(x, p + "norm2", eps)
            qq = _rope_axial(heads(r.lin(h, p + "cross_attn.q_proj")), cos, sin)
            kk = _rope_axial(heads(r.lin(y, p + "cross_attn.k_proj")), cos, sin).expand(n, -1, -1, -1)
            vv = heads(r.lin(y, p + "cross_attn.v_proj")).expand(n, -1, -1, -1)
            a = r.attend(qq, kk, vv)
            x = x + r.lin(a.transpose(1, 2).reshape(n, t, d), p + "cross_attn.proj")
            h = r.ln(x, p + "norm3", eps)
        else:
            h = r.ln(x, p + "norm2", eps)
        x = x + r.lin(F.gelu(r.lin(h, p + "mlp.fc1")), p + "mlp.fc2")
    return r.lin(x, name + ".linear_out")


def _pixel_shuffle(r: Ref, name: str, tokens: Tensor, hw, p: int) -> Tensor:
    h, w = hw
    n = tokens.shape[0]
    feat = r.lin(tokens, name)
    c = feat.shape[-1] // (p * p)
    return feat.reshape(n, h // p, w // p, c, p, p).permute(0, 1, 4, 2, 5, 3).reshape(n, h, w, c)


def _so3(m: Tensor) -> Tensor:
    """9 numbers -> the nearest rotation (the special-orthogonal Procrustes solution
    of the row-normalised 3x3 matrix)."""
    m = m.reshape(-1, 3, 3)
    m = m / torch.linalg.norm(m, dim=-1, keepdim=True).clamp_min(1e-12)
    u, _, vh = torch.linalg.svd(m.transpose(-1, -2))
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    v = torch.cat([v[..., :-1], v[..., -1:] * det[:, None, None]], -1)
    return v @ u.transpose(-1, -2)


def pi3_heads(r: Ref, hidden: Tensor, hw) -> Dict[str, Tensor]:
    """hidden (N, hp*wp, D): the decoder's states at the dino rows -> points,
    local_points, global_points (N, H, W, 3) and camera_poses (N, 4, 4)."""
    p = r.cfg["dino"]["patch_size"]
    n = hidden.shape[0]
    hp, wp = hw[0] // p, hw[1] // p
    pos = torch.stack(torch.meshgrid(torch.arange(hp), torch.arange(wp), indexing="ij"), -1).reshape(-1, 2)
    pos = pos.to(hidden.device)
    pts = _pixel_shuffle(r, "point_head.proj", pi3_decoder(r, "point_decoder", hidden, pos), hw, p)
    z = torch.exp(pts[..., 2:])
    local = torch.cat([pts[..., :2] * z, z], -1)
    x = pi3_decoder(r, "camera_decoder", hidden, pos)
    for i in range(2):
        h = x
        for j in (1, 2, 3):
            h = F.relu(r.lin(h, f"camera_head.res_conv.{i}.res_conv{j}"))
        x = x + h
    x = x.mean(1)
    x = F.relu(r.lin(F.relu(r.lin(x, "camera_head.more_mlps.0")), "camera_head.more_mlps.2"))
    pose = torch.zeros((n, 4, 4), device=x.device)
    pose[:, :3, :3] = _so3(r.lin(x, "camera_head.fc_rot"))
    pose[:, :3, 3] = r.lin(x, "camera_head.fc_t")
    pose[:, 3, 3] = 1.0
    out = {"local_points": local, "camera_poses": pose,
           "points": torch.einsum("nij,nhwj->nhwi", pose[:, :3, :3], local) + pose[:, None, None, :3, 3]}
    if r.cfg.get("use_global_points", True):
        g = pi3_decoder(r, "global_points_decoder", hidden, pos, ctx=hidden[:1])
        out["global_points"] = _pixel_shuffle(r, "global_point_head.proj", g, hw, p)
    return out


# ---------------------------------------------------------------------------
# the Qwen2-VL ViT
# ---------------------------------------------------------------------------


def vision_rope(coords: Tensor, head_dim: int, theta: float = 10000.0) -> Tuple[Tensor, Tensor]:
    dim = head_dim // 2
    inv = torch.from_numpy(1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))).to(coords.device)
    half = torch.cat([coords[:, :1].float() * inv, coords[:, 1:].float() * inv], -1)
    ang = torch.cat([half, half], -1)
    return torch.cos(ang), torch.sin(ang)


def merge_order_coords(gh: int, gw: int) -> np.ndarray:
    """(h, w) of each patch row in the 2x2 merge-grouped order of the image processor."""
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")

    def perm(a):
        return a.reshape(gh // 2, 2, gw // 2, 2).transpose(0, 2, 1, 3).reshape(-1)

    return np.stack([perm(hh), perm(ww)], -1)


def vit(r: Ref, patches: Tensor, grid: Tuple[int, int, int]) -> Tensor:
    """One image's patch rows (gh*gw, C*2*p*p) -> merged tokens (gh*gw/4, hidden)."""
    cfg = r.cfg["vit"]
    d, nh = cfg["embed_dim"], cfg["num_heads"]
    hd = d // nh
    _, gh, gw = grid
    s = patches.shape[0]
    cos, sin = vision_rope(torch.as_tensor(merge_order_coords(gh, gw), device=patches.device), hd)
    x = r.mm(patches, r.W["vit_model.patch_embed.proj.weight"].reshape(d, -1).t())
    for i in range(cfg["depth"]):
        p = f"vit_model.blocks.{i}."
        qkv = r.lin(r.ln(x, p + "norm1"), p + "attn.qkv").reshape(s, 3, nh, hd)
        q, k, v = (qkv[:, j].transpose(0, 1)[None] for j in range(3))
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        x = x + r.lin(r.attend(q, k, v)[0].transpose(0, 1).reshape(s, d), p + "attn.proj")
        m = r.lin(r.ln(x, p + "norm2"), p + "mlp.fc1")
        x = x + r.lin(m * torch.sigmoid(1.702 * m), p + "mlp.fc2")
    x = r.ln(x, "vit_model.merger.ln_q").reshape(s // 4, 4 * d)
    return r.lin(F.gelu(r.lin(x, "vit_model.merger.mlp.0")), "vit_model.merger.mlp.2")
