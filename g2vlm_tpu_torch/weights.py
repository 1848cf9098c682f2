"""Weights for the port: the JAX parameter tree -> the port's state dict,
and a seeded random init built directly on the target device.

`state_dict_from_jax` is the exact inverse of g2vlm_tpu's
`models/g2vlm.py:params_from_torch`: it unstacks the leading layer axis and
transposes the `w` matrices back into (out, in) Linear weights. The map is
linear (transposes, unstacking, reshapes), so it also carries a tree of
gradients, of optimizer moments or of an EMA from the JAX tree's layout to
the port's parameter names; the training tests compare them that way.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import G2VLMConfig

from .models import dinov2, mot_decoder, qwen_vit
from .models.g2vlm import G2VLM


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a copy: jax hands out read-only buffers


def _layer(tree, i: int):
    """Slice layer i out of a tree of layer-stacked arrays."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _put_lin(sd: Dict, name: str, p: Dict) -> None:
    sd[name + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[name + ".bias"] = _t(p["b"])


def _put_norm(sd: Dict, name: str, p: Dict) -> None:
    sd[name + ".weight"] = _t(p["w"])
    sd[name + ".bias"] = _t(p["b"])


def _llm(sd: Dict, p: Dict, cfg, pre: str) -> None:
    sd[pre + "model.embed_tokens.weight"] = _t(p["embed"])
    sd[pre + "lm_head.weight"] = _t(np.asarray(p["lm_head"]).T)
    sd[pre + "model.norm.weight"] = _t(p["norm"])
    sd[pre + "model.norm_moe_geo.weight"] = _t(p["norm_geo"])
    for i in range(cfg.num_hidden_layers):
        lp = _layer(p["layers"], i)
        lpre = f"{pre}model.layers.{i}."
        for sfx, tag in (("", ""), ("_moe_geo", "_geo")):
            sd[f"{lpre}input_layernorm{sfx}.weight"] = _t(lp["ln_attn" + tag])
            sd[f"{lpre}post_attention_layernorm{sfx}.weight"] = _t(lp["ln_mlp" + tag])
            for proj in ("q", "k", "v", "o"):
                _put_lin(sd, f"{lpre}self_attn.{proj}_proj{sfx}", lp[proj + tag])
            sd[f"{lpre}self_attn.q_norm{sfx}.weight"] = _t(lp["q_norm" + tag])
            sd[f"{lpre}self_attn.k_norm{sfx}.weight"] = _t(lp["k_norm" + tag])
            for proj in ("gate", "up", "down"):
                _put_lin(sd, f"{lpre}mlp{sfx}.{proj}_proj", lp["mlp" + tag][proj])
        sd[lpre + "ls1.gamma"] = _t(lp["ls1"])
        sd[lpre + "ls2.gamma"] = _t(lp["ls2"])


def _dino(sd: Dict, p: Dict, cfg, pre: str) -> None:
    d, c, ps = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    e = pre + "embeddings."
    sd[e + "cls_token"] = _t(p["cls_token"]).reshape(1, 1, d)
    sd[e + "mask_token"] = _t(p["mask_token"]).reshape(1, d)
    sd[e + "register_tokens"] = _t(p["register_tokens"]).reshape(1, -1, d)
    sd[e + "position_embeddings"] = _t(p["pos_embed"]).reshape(1, -1, d)
    sd[e + "patch_embeddings.projection.weight"] = _t(np.asarray(p["patch_embed"]["w"]).T).reshape(d, c, ps, ps)
    sd[e + "patch_embeddings.projection.bias"] = _t(p["patch_embed"]["b"])
    for i in range(cfg.num_hidden_layers):
        lp = _layer(p["layers"], i)
        lpre = f"{pre}encoder.layer.{i}."
        _put_norm(sd, lpre + "norm1", lp["norm1"])
        _put_norm(sd, lpre + "norm2", lp["norm2"])
        for proj, name in (("q", "query"), ("k", "key"), ("v", "value")):
            _put_lin(sd, f"{lpre}attention.attention.{name}", lp[proj])
        _put_lin(sd, lpre + "attention.output.dense", lp["o"])
        sd[lpre + "layer_scale1.lambda1"] = _t(lp["ls1"])
        sd[lpre + "layer_scale2.lambda1"] = _t(lp["ls2"])
        _put_lin(sd, lpre + "mlp.fc1", lp["fc1"])
        _put_lin(sd, lpre + "mlp.fc2", lp["fc2"])
    _put_norm(sd, pre + "layernorm", p["final_norm"])


def _decoder(sd: Dict, p: Dict, depth: int, pre: str) -> None:
    for i in range(depth):
        bp = _layer(p["blocks"], i)
        bpre = f"{pre}blocks.{i}."
        _put_norm(sd, bpre + "norm1", bp["norm1"])
        _put_norm(sd, bpre + "norm2", bp["norm2"])
        _put_lin(sd, bpre + "attn.qkv", bp["attn"]["qkv"])
        _put_lin(sd, bpre + "attn.proj", bp["attn"]["proj"])
        _put_lin(sd, bpre + "mlp.fc1", bp["mlp"]["fc1"])
        _put_lin(sd, bpre + "mlp.fc2", bp["mlp"]["fc2"])
        if "cross" in bp:
            _put_norm(sd, bpre + "norm3", bp["norm3"])
            _put_norm(sd, bpre + "norm_y", bp["norm_y"])
            for proj in ("q", "k", "v"):
                _put_lin(sd, f"{bpre}cross_attn.{proj}_proj", bp["cross"][proj])
            _put_lin(sd, bpre + "cross_attn.proj", bp["cross"]["proj"])
    _put_lin(sd, pre + "linear_out", p["linear_out"])


def _camera_head(sd: Dict, p: Dict, pre: str) -> None:
    for i, blk in enumerate(p["res_conv"]):
        for j in (1, 2, 3):
            _put_lin(sd, f"{pre}res_conv.{i}.res_conv{j}", blk[f"c{j}"])
    _put_lin(sd, pre + "more_mlps.0", p["mlp1"])
    _put_lin(sd, pre + "more_mlps.2", p["mlp2"])
    _put_lin(sd, pre + "fc_t", p["fc_t"])
    _put_lin(sd, pre + "fc_rot", p["fc_rot"])


def _vit(sd: Dict, p: Dict, cfg, pre: str) -> None:
    conv = (cfg.embed_dim, cfg.in_channels, cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
    sd[pre + "patch_embed.proj.weight"] = _t(np.asarray(p["patch_embed"]["w"]).T).reshape(conv)
    for i in range(cfg.depth):
        bp = _layer(p["blocks"], i)
        bpre = f"{pre}blocks.{i}."
        _put_norm(sd, bpre + "norm1", bp["norm1"])
        _put_norm(sd, bpre + "norm2", bp["norm2"])
        _put_lin(sd, bpre + "attn.qkv", bp["qkv"])
        _put_lin(sd, bpre + "attn.proj", bp["proj"])
        _put_lin(sd, bpre + "mlp.fc1", bp["fc1"])
        _put_lin(sd, bpre + "mlp.fc2", bp["fc2"])
    _put_norm(sd, pre + "merger.ln_q", p["merger"]["ln_q"])
    _put_lin(sd, pre + "merger.mlp.0", p["merger"]["fc1"])
    _put_lin(sd, pre + "merger.mlp.2", p["merger"]["fc2"])


def state_dict_from_jax(params_np: Dict, cfg: G2VLMConfig) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (numpy leaves) -> the port's fp32 CPU state
    dict."""
    sd: Dict[str, torch.Tensor] = {}
    _llm(sd, params_np["llm"], cfg.llm, "language_model.")
    _dino(sd, params_np["dino"], cfg.dino, "dino_model.")
    _put_lin(sd, "dino2llm", params_np["dino2llm"])
    _decoder(sd, params_np["point_decoder"], cfg.pi3.depth, "point_decoder.")
    _decoder(sd, params_np["camera_decoder"], cfg.pi3.depth, "camera_decoder.")
    sd["point_head.proj.weight"] = _t(np.asarray(params_np["point_head"]["proj"]["w"]).T)
    sd["point_head.proj.bias"] = _t(params_np["point_head"]["proj"]["b"])
    _camera_head(sd, params_np["camera_head"], "camera_head.")
    if cfg.use_global_points:
        _decoder(sd, params_np["global_decoder"], cfg.pi3.depth, "global_points_decoder.")
        _put_lin(sd, "global_point_head.proj", params_np["global_point_head"]["proj"])
    if cfg.visual_und:
        _vit(sd, params_np["vit"], cfg.vit, "vit_model.")
    return sd


@torch.no_grad()
def init_random_(model: G2VLM, generator: torch.Generator) -> G2VLM:
    """Fill every parameter in place with the distributions of g2vlm_tpu's
    `init_params`: Linear/conv weights N(0, 1/fan_in), biases 0, norm gains 1,
    token embeddings N(0, 0.02^2), the DINOv2 CLS token N(0, 1), position
    embeddings N(0, 0.02^2), mask and register tokens 0, LayerScales at their
    configured values, the ViT's patch embed N(0, 0.02^2). One exception: `dino2llm` is drawn N(0, 1/fan_in)
    instead of zero, so that the encoder reaches the outputs."""
    cfg = model.cfg
    g = generator
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, qwen_vit.PatchEmbed):
            mod.proj.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, (nn.LayerNorm, mot_decoder.RMSNorm)):
            mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, mot_decoder.LayerScale):
            mod.gamma.fill_(cfg.llm.layer_scale_init)
        elif isinstance(mod, dinov2.LayerScale):
            mod.lambda1.fill_(cfg.dino.layerscale_value)
        elif isinstance(mod, dinov2.Embeddings):
            mod.cls_token.normal_(0.0, 1.0, generator=g)
            mod.mask_token.zero_()
            mod.register_tokens.zero_()
            mod.position_embeddings.normal_(0.0, 0.02, generator=g)
    return model


def build_model(
    cfg: G2VLMConfig,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    seed: Optional[int] = 0,
) -> G2VLM:
    """Construct the model directly on `device` in `dtype` (no host copy of
    the weights) and, with a seed, fill it from a torch.Generator on that
    device. With seed=None the weights are left uninitialized for a
    following load_state_dict. The default device is the card, and without
    one this raises: a caller that wants the CPU says device="cpu"."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device is available; pass device='cpu' to build on the CPU")
    with torch.device("meta"):
        model = G2VLM(cfg)
    model = model.to(dtype).to_empty(device=device).eval()
    if seed is not None:
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    return model
