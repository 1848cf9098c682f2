"""SegFormer mit_b0 with its all-MLP head (port of
g2vlm_tpu/models/segformer.py): the frozen ADE20k segmenter whose sky class
supervises the conf head (`train_conf_pi3`).

Submodule names follow the mmseg key space (`backbone.patch_embed{1..4}`,
`backbone.block{1..4}.{j}.attn.sr`, `backbone.norm{1..4}`,
`decode_head.linear_c{1..4}.proj`, `decode_head.linear_fuse.{conv,bn}`,
`decode_head.linear_pred`), the keys g2vlm_tpu's `segformer.params_from_torch`
reads; the model keeps it under `Pi3Loss.point_loss.segformer.`, where the
reference checkpoints it.

No kernel here, by design: the JAX package computes this attention with plain
einsums (`ops/attention.py` `dense_attention`: head dim 32, keys cut by the
spatial reduction) and the convolutions with `lax.conv`, outside any Pallas
kernel, so plain `torch.matmul` / `softmax` and `F.conv2d` are their faithful
counterpart. Everything runs in fp32, as the JAX trainer runs it on its fp32
parameters, with TF32 off for the convolutions (cuDNN allows it by default,
and a TF32 product flips arg-max pixels of the sky mask against the CPU).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SegformerConfig
from ..ops.norms import layer_norm
from ..utils.image import resize_hw


class BatchNorm(nn.Module):
    """Inference BatchNorm: weight, bias and the running statistics (mmseg's
    `num_batches_tracked` counter has no numeric role and is not kept)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.register_buffer("running_mean", torch.empty(d))
        self.register_buffer("running_var", torch.empty(d))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride=stride, padding=patch // 2)
        self.norm = nn.LayerNorm(cout, eps=1e-5)


class EfficientAttention(nn.Module):
    def __init__(self, d: int, sr_ratio: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.kv = nn.Linear(d, 2 * d)
        self.proj = nn.Linear(d, d)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(d, d, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(d, eps=1e-5)


class DWConv(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dwconv = nn.Conv2d(d, d, 3, padding=1, groups=d)


class MixFFN(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, d: int, mlp_ratio: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = EfficientAttention(d, sr_ratio)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = MixFFN(d, d * mlp_ratio)


class Backbone(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        cin = 3
        for i in range(4):
            e = cfg.embed_dims[i]
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(cin, e, cfg.patch_sizes[i], cfg.strides[i]))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(e, cfg.mlp_ratios[i], cfg.sr_ratios[i]) for _ in range(cfg.depths[i])))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(e, eps=1e-6))
            cin = e


class MLPLayer(nn.Module):
    def __init__(self, d: int, out: int):
        super().__init__()
        self.proj = nn.Linear(d, out)


class LinearFuse(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.conv = nn.Conv2d(4 * d, d, 1, bias=False)
        self.bn = BatchNorm(d)


class DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        dd = cfg.decoder_dim
        for i in range(4):
            setattr(self, f"linear_c{i + 1}", MLPLayer(cfg.embed_dims[i], dd))
        self.linear_fuse = LinearFuse(dd)
        self.linear_pred = nn.Conv2d(dd, cfg.num_classes, 1)


class Segformer(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.decode_head = DecodeHead(cfg)


@contextmanager
def _no_tf32_convs():
    """cuDNN's TF32 off for the convolutions inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, norm.eps)


def _to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:  # (B, h*w, C) -> (B, C, h, w)
    return x.transpose(1, 2).reshape(x.shape[0], -1, h, w)


def _attention(x: torch.Tensor, at: EfficientAttention, h: int, w: int, num_heads: int) -> torch.Tensor:
    """Efficient self attention: the keys and values come from the map cut
    by the spatial-reduction conv (sr_ratio^2 fewer rows)."""
    b, n, c = x.shape
    hd = c // num_heads
    q = F.linear(x, at.q.weight, at.q.bias).view(b, n, num_heads, hd).transpose(1, 2)
    xs = x
    if hasattr(at, "sr"):
        xs = F.conv2d(_to_map(x, h, w), at.sr.weight, at.sr.bias, stride=at.sr.stride)
        xs = _ln(xs.flatten(2).transpose(1, 2), at.norm)
    kv = F.linear(xs, at.kv.weight, at.kv.bias).view(b, xs.shape[1], 2, num_heads, hd)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
    return F.linear(out, at.proj.weight, at.proj.bias)


def _mix_ffn(x: torch.Tensor, mlp: MixFFN, h: int, w: int) -> torch.Tensor:
    """fc1, the 3x3 depthwise conv, exact GELU, fc2."""
    x = F.linear(x, mlp.fc1.weight, mlp.fc1.bias)
    dw = mlp.dwconv.dwconv
    x = F.conv2d(_to_map(x, h, w), dw.weight, dw.bias, padding=1, groups=dw.groups)
    x = F.gelu(x.flatten(2).transpose(1, 2))
    return F.linear(x, mlp.fc2.weight, mlp.fc2.bias)


def forward_features(model: Segformer, images: torch.Tensor) -> List[torch.Tensor]:
    """(B, 3, H, W) -> the 4 feature maps (B, C_i, H/4 .. H/32, ...), in the
    parameters' dtype (fp32 in training)."""
    cfg, bb = model.cfg, model.backbone
    x, outs = images.to(bb.norm1.weight.dtype), []
    for i in range(4):
        pe = getattr(bb, f"patch_embed{i + 1}")
        x = F.conv2d(x, pe.proj.weight, pe.proj.bias, stride=pe.proj.stride, padding=pe.proj.padding)
        b, c, h, w = x.shape
        x = _ln(x.flatten(2).transpose(1, 2), pe.norm)
        for blk in getattr(bb, f"block{i + 1}"):
            x = x + _attention(_ln(x, blk.norm1), blk.attn, h, w, cfg.num_heads[i])
            x = x + _mix_ffn(_ln(x, blk.norm2), blk.mlp, h, w)
        x = _to_map(_ln(x, getattr(bb, f"norm{i + 1}")), h, w)
        outs.append(x)
    return outs


def seg_logits(model: Segformer, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, num_classes, H, W) logits. Every resize here
    upsamples (the maps are H/4 .. H/32), where the port's antialiased
    bilinear `resize_hw` equals the plain bilinear of the JAX package."""
    head = model.decode_head
    with _no_tf32_convs():
        feats = forward_features(model, images)
        target = feats[0].shape[2:]
        ups = []
        for i in (3, 2, 1, 0):
            f = feats[i]
            lin = getattr(head, f"linear_c{i + 1}").proj
            t = _to_map(F.linear(f.flatten(2).transpose(1, 2), lin.weight, lin.bias), *f.shape[2:])
            ups.append(resize_hw(t, tuple(target), mode="bilinear"))
        fuse = head.linear_fuse
        x = F.conv2d(torch.cat(ups, dim=1), fuse.conv.weight)
        scale = fuse.bn.weight / torch.sqrt(fuse.bn.running_var + 1e-5)
        x = F.relu(x * scale[None, :, None, None] + (fuse.bn.bias - fuse.bn.running_mean * scale)[None, :, None, None])
        x = F.conv2d(x, head.linear_pred.weight, head.linear_pred.bias)
    return resize_hw(x, tuple(images.shape[2:]), mode="bilinear")


def predict_sky_mask(model: Segformer, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, H, W) bool: arg-max class == the sky class."""
    return seg_logits(model, images).argmax(dim=1) == model.cfg.sky_class
