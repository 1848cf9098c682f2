"""Weights for the port: the checkpoint ingest (a reference checkpoint
directory -> a model on the device, strict both ways), the JAX parameter tree
-> the port's state dict, and a seeded random init built directly on the
target device.

The port's parameter names are the reference checkpoint's keys, so the set
of keys the model consumes is `model.state_dict()` itself; the JAX package
reads the same set through its mapper (`g2vlm_tpu/models/g2vlm.py`
`params_from_torch`). `load_safetensors` reads the format itself (an 8-byte
little-endian header length, a JSON header, then raw bytes), so the port
does not need the `safetensors` package.

`state_dict_from_jax` is the exact inverse of g2vlm_tpu's
`models/g2vlm.py:params_from_torch`: it unstacks the leading layer axis and
transposes the `w` matrices back into (out, in) Linear weights. The map is
linear (transposes, unstacking, reshapes), so it also carries a tree of
gradients, of optimizer moments or of an EMA from the JAX tree's layout to
the port's parameter names; the training tests compare them that way.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import G2VLMConfig, SegformerConfig

from .models import dinov2, dinov3, mla_moe_decoder, mot_decoder, qwen_vit, segformer
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
    """The decoder of any layer module: the geo expert's leaves for "mot",
    `mlp_moe_geo` alone for "moe", none for "dense"."""
    sd[pre + "model.embed_tokens.weight"] = _t(p["embed"])
    sd[pre + "lm_head.weight"] = _t(np.asarray(p["lm_head"]).T)
    sd[pre + "model.norm.weight"] = _t(p["norm"])
    if cfg.use_moe:
        sd[pre + "model.norm_moe_geo.weight"] = _t(p["norm_geo"])
    mot = cfg.layer_module == "mot"
    for i in range(cfg.num_hidden_layers):
        lp = _layer(p["layers"], i)
        lpre = f"{pre}model.layers.{i}."
        for sfx, tag in (("", ""), ("_moe_geo", "_geo")) if mot else (("", ""),):
            sd[f"{lpre}input_layernorm{sfx}.weight"] = _t(lp["ln_attn" + tag])
            sd[f"{lpre}post_attention_layernorm{sfx}.weight"] = _t(lp["ln_mlp" + tag])
            for proj in ("q", "k", "v", "o"):
                _put_lin(sd, f"{lpre}self_attn.{proj}_proj{sfx}", lp[proj + tag])
            sd[f"{lpre}self_attn.q_norm{sfx}.weight"] = _t(lp["q_norm" + tag])
            sd[f"{lpre}self_attn.k_norm{sfx}.weight"] = _t(lp["k_norm" + tag])
        for sfx, tag in (("", ""), ("_moe_geo", "_geo")) if cfg.use_moe else (("", ""),):
            for proj in ("gate", "up", "down"):
                _put_lin(sd, f"{lpre}mlp{sfx}.{proj}_proj", lp["mlp" + tag][proj])
        if mot:
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


def _dinov3(sd: Dict, p: Dict, cfg, pre: str) -> None:
    d, c, ps = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    e = pre + "embeddings."
    sd[e + "cls_token"] = _t(p["cls_token"]).reshape(1, 1, d)
    sd[e + "register_tokens"] = _t(p["register_tokens"]).reshape(1, -1, d)
    sd[e + "patch_embeddings.weight"] = _t(np.asarray(p["patch_embed"]["w"]).T).reshape(d, c, ps, ps)
    sd[e + "patch_embeddings.bias"] = _t(p["patch_embed"]["b"])
    for i in range(cfg.num_hidden_layers):
        lp = _layer(p["layers"], i)
        lpre = f"{pre}layer.{i}."
        _put_norm(sd, lpre + "norm1", lp["norm1"])
        _put_norm(sd, lpre + "norm2", lp["norm2"])
        for proj in ("q", "k", "v", "o"):
            _put_lin(sd, f"{lpre}attention.{proj}_proj", lp[proj])
        sd[lpre + "layer_scale1.lambda1"] = _t(lp["ls1"])
        sd[lpre + "layer_scale2.lambda1"] = _t(lp["ls2"])
        for proj in ("gate", "up", "down") if cfg.use_gated_mlp else ("up", "down"):
            _put_lin(sd, f"{lpre}mlp.{proj}_proj", lp[proj])
    _put_norm(sd, pre + "norm", p["final_norm"])


def _segformer(sd: Dict, p: Dict, pre: str) -> None:
    """The inverse of g2vlm_tpu's `segformer.params_from_torch`."""
    cfg = SegformerConfig()

    def conv(name, q):
        sd[name + ".weight"] = _t(q["w"])
        if q.get("b") is not None:
            sd[name + ".bias"] = _t(q["b"])

    for si in range(4):
        sp, bb = p[f"stage{si}"], f"{pre}backbone."
        conv(f"{bb}patch_embed{si + 1}.proj", sp["patch"])
        _put_norm(sd, f"{bb}patch_embed{si + 1}.norm", sp["patch_norm"])
        _put_norm(sd, f"{bb}norm{si + 1}", sp["norm"])
        for li in range(cfg.depths[si]):
            lp, bpre = sp[f"block{li}"], f"{bb}block{si + 1}.{li}."
            _put_norm(sd, bpre + "norm1", lp["norm1"])
            _put_norm(sd, bpre + "norm2", lp["norm2"])
            for name in ("q", "kv", "proj"):
                _put_lin(sd, f"{bpre}attn.{name}", lp["attn"][name])
            if "sr" in lp["attn"]:
                conv(bpre + "attn.sr", lp["attn"]["sr"])
                _put_norm(sd, bpre + "attn.norm", lp["attn"]["sr_norm"])
            _put_lin(sd, bpre + "mlp.fc1", lp["mlp"]["fc1"])
            conv(bpre + "mlp.dwconv.dwconv", lp["mlp"]["dw"])
            _put_lin(sd, bpre + "mlp.fc2", lp["mlp"]["fc2"])
    head, hpre = p["head"], pre + "decode_head."
    for i in range(1, 5):
        _put_lin(sd, f"{hpre}linear_c{i}.proj", head[f"linear_c{i}"])
    conv(hpre + "linear_fuse.conv", head["fuse"])
    bn = head["fuse_bn"]
    for key, name in (("w", "weight"), ("b", "bias"), ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{hpre}linear_fuse.bn.{name}"] = _t(bn[key])
    conv(hpre + "linear_pred", head["pred"])


SEGFORMER_PREFIX = "Pi3Loss.point_loss.segformer."


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
    dict. With `cfg.use_dinov3`, `params_np["dino"]` is the DINOv3 tree
    (`g2vlm_tpu.models.dinov3.init_params`'s layout); with
    `cfg.train_conf_pi3`, the conf decoder and head and the SegFormer are
    carried where the tree holds them."""
    sd: Dict[str, torch.Tensor] = {}
    _llm(sd, params_np["llm"], cfg.llm, "language_model.")
    if cfg.use_dinov3:
        _dinov3(sd, params_np["dino"], cfg.dinov3, "dino_model.")
    else:
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
    if cfg.train_conf_pi3 and "conf_decoder" in params_np:
        _decoder(sd, params_np["conf_decoder"], cfg.pi3.depth, "conf_decoder.")
        _put_lin(sd, "conf_head.proj", params_np["conf_head"]["proj"])
    if cfg.train_conf_pi3 and "segformer" in params_np:
        _segformer(sd, params_np["segformer"], SEGFORMER_PREFIX)
    if cfg.visual_und:
        _vit(sd, params_np["vit"], cfg.vit, "vit_model.")
    return sd


@torch.no_grad()
def init_random_(model: G2VLM, generator: torch.Generator, prefixes: Optional[Tuple[str, ...]] = None) -> G2VLM:
    """Fill every parameter in place with the distributions of g2vlm_tpu's
    `init_params`: Linear/conv weights N(0, 1/fan_in), biases 0, norm gains 1,
    token embeddings N(0, 0.02^2), the DINOv2 CLS token N(0, 1), position
    embeddings N(0, 0.02^2), mask and register tokens 0, LayerScales at their
    configured values, the ViT's patch embed N(0, 0.02^2), the "mla_moe"
    decoder's routed experts N(0, 1/fan_in) each and its routers' correction
    biases 0, DINOv3's patch
    embed, CLS and register tokens N(0, 0.02^2), the SegFormer's BatchNorm at
    identity statistics. One exception: `dino2llm` is drawn N(0, 1/fan_in)
    instead of zero, so that the encoder reaches the outputs. With `prefixes`
    only the modules under those state-dict prefixes (each ending in ".")."""
    cfg = model.cfg
    g = generator
    for name, mod in model.named_modules():
        if prefixes is not None and not (name + ".").startswith(prefixes):
            continue
        if isinstance(mod, dinov3.PatchEmbeddings):
            mod.weight.normal_(0.0, 0.02, generator=g)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
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
        elif isinstance(mod, mla_moe_decoder.RoutedExperts):  # each expert's leaves N(0, 1/fan_in)
            mod.gate_up.normal_(0.0, mod.gate_up.shape[2] ** -0.5, generator=g)
            mod.down.normal_(0.0, mod.down.shape[2] ** -0.5, generator=g)
        elif isinstance(mod, mla_moe_decoder.Router):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=g)
            mod.e_score_correction_bias.zero_()
        elif isinstance(mod, mot_decoder.LayerScale):
            mod.gamma.fill_(cfg.llm.layer_scale_init)
        elif isinstance(mod, dinov2.LayerScale):
            mod.lambda1.fill_(cfg.dino.layerscale_value)
        elif isinstance(mod, dinov2.Embeddings):
            mod.cls_token.normal_(0.0, 1.0, generator=g)
            mod.mask_token.zero_()
            mod.register_tokens.zero_()
            mod.position_embeddings.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, dinov3.LayerScale):
            mod.lambda1.fill_(cfg.dinov3.layerscale_value)
        elif isinstance(mod, dinov3.Embeddings):
            mod.cls_token.normal_(0.0, 0.02, generator=g)
            mod.register_tokens.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, segformer.BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model


@torch.no_grad()
def init_moe_from_dense(model: G2VLM) -> G2VLM:
    """Bootstrap the geo expert from the base one, in place: every decoder
    leaf named `*_moe_geo*` (the geo expert's norms, projections, qk-norms
    and MLP, and the final `norm_moe_geo`) takes a copy of its base leaf, as
    g2vlm_tpu's `weights.init_moe_from_dense` does. The LayerScales stay. A
    model without geo leaves ("dense") is left as it is."""
    named = dict(model.language_model.named_parameters())
    for name, p in named.items():
        if "_moe_geo" in name:
            p.copy_(named[name.replace("_moe_geo", "")])
    return model


def load_segformer_pth(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's frozen sky segmenter weights (an mmseg pickle, e.g.
    segformer.b0.512x512.ade.160k.pth, holding {'state_dict': {backbone.* /
    decode_head.*}}) -> the state dict of the port's `Segformer`: the keys
    g2vlm_tpu's `segformer.params_from_torch` reads, as fp32 on `device`. A
    key it needs and the file lacks raises KeyError with its name. The file
    is a pickle: load only one from a source you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    with torch.device("meta"):
        want = list(segformer.Segformer(SegformerConfig()).state_dict())
    return {k: torch.as_tensor(sd[k]).to(device=device, dtype=torch.float32) for k in want}


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


# ---------------------------------------------------------------------------
# checkpoint ingest
# ---------------------------------------------------------------------------

# safetensors dtype -> (little-endian numpy dtype of the stored bytes, torch dtype); numpy has no
# bfloat16, so BF16 is read as uint16 and reinterpreted
_SAFETENSORS_DTYPES = {
    "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16),
    "BF16": ("<u2", torch.bfloat16),
    "I64": ("<i8", torch.int64),
    "I32": ("<i4", torch.int32),
}


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write {key: tensor} (any device; F32, F16, BF16, I64 or I32) as a
    `.safetensors` file that `load_safetensors` and the `safetensors` package
    read: an 8-byte little-endian header length, a JSON header padded with
    spaces to 8 bytes, then each tensor's bytes in the header's order. The
    port's own writer: the card's machine has no safetensors package."""
    names = {dtype: name for name, (_, dtype) in _SAFETENSORS_DTYPES.items()}
    header, offset = {}, 0
    for key, t in tensors.items():
        if t.dtype not in names:
            raise ValueError(f"save_safetensors: {key} has dtype {t.dtype}; the format here takes {sorted(names)}")
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    # the header needs only shapes and dtypes, so each tensor is brought to the host as it is
    # written: the peak host memory is one tensor, not the whole state
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            f.write(memoryview(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()))


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` file -> {key: host tensor}. The file is
    memory-mapped (copy-on-write), so the tensors share its pages and a later
    copy onto the card is the only copy. Raises ValueError on a header that is cut
    short, whose entries overlap or run past the end of the file, or whose
    sizes disagree with their shapes, and on a dtype outside F32, F16, BF16,
    I64 and I32."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n_header,) = struct.unpack("<Q", head)
        if n_header > size - 8:
            raise ValueError(f"{path}: header of {n_header} bytes runs past the end of the file ({size} bytes)")
        header = json.loads(f.read(n_header))
    header.pop("__metadata__", None)
    data_start, data_len = 8 + n_header, size - 8 - n_header
    spans = []
    for key, e in header.items():
        if e.get("dtype") not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {key} has dtype {e.get('dtype')!r}; the port reads "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = e["data_offsets"]
        itemsize = np.dtype(_SAFETENSORS_DTYPES[e["dtype"]][0]).itemsize
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: {key} spans bytes [{begin}, {end}) outside the {data_len} data bytes")
        if end - begin != int(np.prod(e["shape"], dtype=np.int64)) * itemsize:
            raise ValueError(f"{path}: {key} holds {end - begin} bytes, not those of shape {e['shape']} "
                             f"in {e['dtype']}")
        spans.append((begin, end, key))
    spans.sort()
    for (_, end0, k0), (begin1, _, k1) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise ValueError(f"{path}: {k0} and {k1} overlap")
    # np.memmap refuses an empty map; a file of empty tensors holds no data bytes
    data = np.zeros(0, np.uint8)
    if data_len:
        data = np.memmap(path, np.uint8, mode="c", offset=data_start, shape=(data_len,))
    out = {}
    for begin, end, key in spans:
        e = header[key]
        np_dtype, dtype = _SAFETENSORS_DTYPES[e["dtype"]]
        arr = data[begin:end].view(np_dtype)
        if arr.ctypes.data % arr.itemsize:
            arr = arr.copy()  # an entry off its dtype's alignment
        t = torch.from_numpy(arr)
        if dtype is torch.bfloat16:
            t = t.view(torch.bfloat16)
        t = t.reshape(e["shape"])
        out[key] = t
    return out


def absent_optional(state_dict: Mapping, cfg: G2VLMConfig) -> Tuple[str, ...]:
    """The state-dict prefixes of the modules that a model of `cfg` may take
    from the checkpoint but that this one lacks entirely. Only a config that
    trains the conf head has such: the conf decoder with its head (present
    when any `conf_decoder.` key is) and the SegFormer (when any
    `Pi3Loss.point_loss.segformer.` key is), as g2vlm_tpu's mapper takes
    them; train.py fills what is absent from its seed."""
    if not cfg.train_conf_pi3:
        return ()
    out = ()
    if not any(k.startswith("conf_decoder.") for k in state_dict):
        out += ("conf_decoder.", "conf_head.")
    if not any(k.startswith(SEGFORMER_PREFIX) for k in state_dict):
        out += (SEGFORMER_PREFIX,)
    return out


def _ignorable(key: str, cfg: G2VLMConfig) -> bool:
    """Checkpoint keys that no module of the port consumes, legitimately: the
    BatchNorm step counters, and the frozen sky segmenter under the loss
    module unless the config trains the conf head (then it is consumed)."""
    if key.endswith("num_batches_tracked"):
        return True
    if not cfg.train_conf_pi3 and key.startswith("Pi3Loss."):
        return True
    return False


def model_keys(cfg: G2VLMConfig) -> List[str]:
    """The keys a model of `cfg` consumes, in its order: its state-dict keys,
    read from a model built on the meta device (no memory)."""
    with torch.device("meta"):
        return list(G2VLM(cfg).state_dict())


def audit_keys(state_dict: Mapping, cfg: G2VLMConfig) -> Dict[str, List[str]]:
    """Exact two-way key diff between a checkpoint's state dict and what a
    model of `cfg` consumes: {"unknown": checkpoint keys no module consumes
    (sorted), "missing": keys the model needs and the checkpoint lacks}; both
    empty on a clean checkpoint. "missing" lists every such key, in the
    model's order; the JAX package's mapper stops at the first one it reads,
    so the two lists are equal where one key is missing."""
    return _diff_keys(state_dict, model_keys(cfg), cfg)


def _diff_keys(state_dict: Mapping, want: List[str], cfg: G2VLMConfig) -> Dict[str, List[str]]:
    """audit_keys against the key list `want` of a model of `cfg`; the
    optional modules the checkpoint lacks entirely (`absent_optional`) are
    not missing."""
    wanted = set(want)
    absent = absent_optional(state_dict, cfg)
    return {
        "unknown": sorted(k for k in state_dict if k not in wanted and not _ignorable(k, cfg)),
        "missing": [k for k in want if k not in state_dict and not k.startswith(absent)],
    }


def load_checkpoint(
    checkpoint_dir: str,
    strict: bool = True,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    cfg: Optional[G2VLMConfig] = None,
    seed: int = 0,
) -> Tuple[G2VLM, G2VLMConfig]:
    """Read a reference checkpoint directory (text_config.json /
    vit_config.json / dino_config.json + model.safetensors) into a model built
    on `device` in `dtype` (each tensor is cast on its one copy into the
    model). `cfg` defaults to the directory's config; train_torch.py passes it
    with `train_conf_pi3` for --train_conf (as train.py passes the JAX
    loader), and then the conf decoder and head and the SegFormer come from
    the file where it holds them and are otherwise drawn from `seed`
    (`absent_optional`). A key the model needs and the file
    lacks raises KeyError with its name; with `strict`, so does a file key
    that no module consumes (up to 20 listed), so a renamed key can never load
    garbage silently. The default device is the card, and without one this
    raises, as `build_model` does."""
    if cfg is None:
        cfg = G2VLMConfig.from_checkpoint_dir(checkpoint_dir)
    model = build_model(cfg, device=device, dtype=dtype, seed=None)
    sd = load_safetensors(os.path.join(checkpoint_dir, "model.safetensors"))
    want = list(model.state_dict())
    diff = _diff_keys(sd, want, cfg)
    if diff["missing"]:
        raise KeyError(diff["missing"][0])
    if strict and diff["unknown"]:
        raise KeyError(f"checkpoint has {len(diff['unknown'])} keys no module consumed "
                       f"(renamed/extra?): {diff['unknown'][:20]}")
    absent = absent_optional(sd, cfg)
    if absent:
        init_random_(model, torch.Generator(device=device).manual_seed(seed), prefixes=absent)
    model.load_state_dict({k: sd[k] for k in want if not k.startswith(absent)}, strict=not absent)
    return model, cfg


def module_checksums(model) -> Dict[str, Dict]:
    """Per-top-level-module fingerprints of a model or of a state dict in its
    key space: {module: {leaves (tensors), params (elements), value_sum (fp64
    sum of the values)}}, to compare a load against another implementation's
    load of the same checkpoint without shipping the weights."""
    tensors = model.state_dict() if isinstance(model, nn.Module) else model
    out: Dict[str, Dict] = {}
    for key, t in tensors.items():
        info = out.setdefault(key.split(".", 1)[0], {"leaves": 0, "params": 0, "value_sum": 0.0})
        info["leaves"] += 1
        info["params"] += t.numel()
        info["value_sum"] += float(t.sum(dtype=torch.float64))
    return out


def _audit_cli(checkpoint_dir: str) -> int:
    """`python -m g2vlm_tpu_torch.weights --audit <ckpt_dir>`: the exact
    two-way key diff (checkpoint keys no module consumes; keys the model needs
    and the checkpoint lacks), then per-module checksums of what the model
    consumes. Host only: the tensors stay memory-mapped. Exit code 0 only on
    a clean two-way match."""
    cfg = G2VLMConfig.from_checkpoint_dir(checkpoint_dir)
    sd = load_safetensors(os.path.join(checkpoint_dir, "model.safetensors"))
    print(f"checkpoint: {len(sd)} tensors, {sum(v.numel() for v in sd.values()) / 1e9:.3f}B params")
    want = model_keys(cfg)
    diff = _diff_keys(sd, want, cfg)
    for kind in ("missing", "unknown"):
        ks = diff[kind]
        label = "model needs, checkpoint lacks" if kind == "missing" else "checkpoint has, no module consumed"
        print(f"{kind} ({label}): {len(ks)}")
        for k in ks[:50]:
            print(f"  {k}")
        if len(ks) > 50:
            print(f"  ... and {len(ks) - 50} more")
    if diff["missing"]:
        print("AUDIT: FAIL (cannot build the model: missing keys above)")
        return 1
    print("per-module checksums (count / value sum):")
    for mod, info in sorted(module_checksums({k: sd[k] for k in want}).items()):
        print(f"  {mod:22s} {info['params']:>13,d}  sum={info['value_sum']:+.6e}")
    if diff["unknown"]:
        print("AUDIT: FAIL (unconsumed checkpoint keys above)")
        return 1
    print("AUDIT: PASS (exact two-way key match)")
    return 0


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Strict two-way audit of a reference checkpoint dir (text/vit/dino_config.json + "
                    "model.safetensors)")
    ap.add_argument("--audit", metavar="CKPT_DIR", required=True)
    sys.exit(_audit_cli(ap.parse_args().audit))
