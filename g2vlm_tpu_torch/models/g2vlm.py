"""G2VLM model (port of g2vlm_tpu/models/g2vlm.py: the recon path, the chat
prefill and the pieces the training step calls).

`G2VLM` owns the MoT LLM, the geometry encoder (DINOv2, or DINOv3 with
`cfg.use_dinov3`), the `dino2llm` projection, the Pi3 heads, with
`cfg.train_conf_pi3` the conf decoder and head and the frozen SegFormer that
supervises them, and with `cfg.visual_und` the Qwen2-VL ViT, under the
reference's state-dict prefixes (`language_model.`, `dino_model.`,
`dino2llm.`, `point_decoder.`, `camera_decoder.`, `global_points_decoder.`,
`point_head.`, `camera_head.`, `global_point_head.`, `conf_decoder.`,
`conf_head.`, `Pi3Loss.point_loss.segformer.`, `vit_model.`), which are the
keys g2vlm_tpu's `params_from_torch` reads. Recon is one packed prefill
through the decoder, then the heads over the hidden states at the dino-token
rows; the chat prefill mixes dino, ViT and text rows, and its per-layer rows
fill the decode cache. The decoder family is chosen once, at construction: the
MoT (models/mot_decoder.py; its prefill routes GEO_MAIN, SPLIT or MIXED) or
Kimi-VL-A3B's MLA + MoE language model (models/mla_moe_decoder.py); all else
asks `language_model`.

`PackedPrefill` and `SequenceBuilder` are numpy host code, the port's own copy
of the JAX module's (the port imports nothing of g2vlm_tpu); a test holds the
copy field for field equal to the JAX builder.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import G2VLMConfig, SegformerConfig

from ..ops.linear import linear
from ..ops.masks import TokenInfo
from ..utils import tracing
from ..utils.geometry import homogenize_points
from . import dinov2, dinov3, mla_moe_decoder, mot_decoder, pi3_heads, qwen_vit, segformer
from .mot_decoder import split_order  # noqa: F401  (the SPLIT sort, read by tools and tests from here)


class PackedPrefill(NamedTuple):
    """Host-built static inputs for one packed prefill forward."""

    text_ids: np.ndarray  # (T,) int32 token ids for all text slots
    text_indexes: np.ndarray  # (T,) positions of text tokens in the sequence
    dino_indexes: np.ndarray  # (N*hw,) positions of dino patch tokens
    vit_indexes: np.ndarray  # (V,) positions of vit image tokens
    is_geo: np.ndarray  # (S,) bool
    position_ids: np.ndarray  # (3, S)
    doc_id: np.ndarray
    fn_id: np.ndarray
    noise_id: np.ndarray
    pos: np.ndarray
    seq_len: int
    next_rope_pos: int  # first free rope position after the sequence

    def token_info(self, device=None) -> TokenInfo:
        return TokenInfo.from_numpy(self.doc_id, self.fn_id, self.noise_id, self.pos, device=device)


class SequenceBuilder:
    """Builds the packed sequence and its metadata for ONE forward. Phases:
      add_text(ids)            -> causal tokens (fn=-1)
      add_dino_images(n,hp,wp) -> <vision_start> + patches + <vision_end> per
                                  view, bidirectional across ALL dino views
                                  (one shared fn id)
      add_vit_image(hp,wp)     -> framed vit tokens, bidirectional per image
    """

    def __init__(self, start_of_image: int, end_of_image: int):
        self.soi = start_of_image
        self.eoi = end_of_image
        self.text_ids = []
        self.text_indexes = []
        self.dino_indexes = []
        self.vit_indexes = []
        self.is_geo = []
        self.pos_ids = []  # list of (3, 1) or (3, n)
        self.fn_id = []
        self.curr = 0  # sequence cursor
        self.rope = 0  # rope position cursor
        self.next_fn = 0

    def add_text(self, ids) -> None:
        for t in ids:
            self._push_text_token_fn(int(t), -1)

    def _grid_pos(self, hp: int, wp: int) -> np.ndarray:
        t_idx = np.zeros(hp * wp, np.int64)
        h_idx = np.repeat(np.arange(hp, dtype=np.int64), wp)
        w_idx = np.tile(np.arange(wp, dtype=np.int64), hp)
        return np.stack([t_idx, h_idx, w_idx]) + self.rope

    def add_dino_images(self, n_views: int, hp: int, wp: int) -> None:
        """Per view <vision_start>, hw patch tokens with 3D rope ids, then
        <vision_end>; rope advances by max(hp, wp) per grid."""
        fn = self.next_fn
        self.next_fn += 1
        hw = hp * wp
        for _ in range(n_views):
            self._push_text_token_fn(self.soi, fn)
            self.dino_indexes.extend(range(self.curr, self.curr + hw))
            self.is_geo.extend([True] * hw)
            self.pos_ids.append(self._grid_pos(hp, wp))
            self.fn_id.append(np.full(hw, fn, np.int32))
            self.curr += hw
            self.rope += max(hp, wp)
            self._push_text_token_fn(self.eoi, fn)

    def add_vit_image(self, hp_merged: int, wp_merged: int) -> None:
        fn = self.next_fn
        self.next_fn += 1
        hw = hp_merged * wp_merged
        self._push_text_token_fn(self.soi, fn)
        self.vit_indexes.extend(range(self.curr, self.curr + hw))
        self.is_geo.extend([False] * hw)
        self.pos_ids.append(self._grid_pos(hp_merged, wp_merged))
        self.fn_id.append(np.full(hw, fn, np.int32))
        self.curr += hw
        self.rope += max(hp_merged, wp_merged)
        self._push_text_token_fn(self.eoi, fn)

    def _push_text_token_fn(self, tok: int, fn: int):
        self.text_ids.append(tok)
        self.text_indexes.append(self.curr)
        self.is_geo.append(False)
        self.pos_ids.append(np.full((3, 1), self.rope, np.int64))
        self.fn_id.append(np.full(1, fn, np.int32))
        self.curr += 1
        self.rope += 1

    def build(self, pad_to: Optional[int] = None) -> PackedPrefill:
        s = self.curr
        total = pad_to if pad_to is not None else s
        if total < s:
            raise ValueError(f"pad_to {total} is shorter than the sequence ({s})")
        doc = np.full(total, -1, np.int32)
        doc[:s] = 0
        fn = np.full(total, -1, np.int32)
        fn[:s] = np.concatenate(self.fn_id)
        pos_meta = np.zeros(total, np.int32)
        pos_meta[:s] = np.arange(s, dtype=np.int32)
        position_ids = np.zeros((3, total), np.int64)
        position_ids[:, :s] = np.concatenate(self.pos_ids, axis=1)
        is_geo = np.zeros(total, bool)
        is_geo[:s] = np.asarray(self.is_geo)
        return PackedPrefill(
            text_ids=np.asarray(self.text_ids, np.int32),
            text_indexes=np.asarray(self.text_indexes, np.int32),
            dino_indexes=np.asarray(self.dino_indexes, np.int32),
            vit_indexes=np.asarray(self.vit_indexes, np.int32),
            is_geo=is_geo,
            position_ids=position_ids,
            doc_id=doc,
            fn_id=fn,
            noise_id=np.full(total, -1, np.int32),
            pos=pos_meta,
            seq_len=s,
            next_rope_pos=self.rope,
        )


class _Pi3Loss(nn.Module):
    """The reference checkpoints the frozen sky segmenter under its loss
    module: `Pi3Loss.point_loss.segformer.*`."""

    def __init__(self):
        super().__init__()
        self.point_loss = nn.Module()
        self.point_loss.segformer = segformer.Segformer(SegformerConfig())


class G2VLM(nn.Module):
    """LLM + geometry encoder + dino2llm + Pi3 heads; the conf decoder, conf
    head and SegFormer when `cfg.train_conf_pi3`; the Qwen2-VL ViT when
    `cfg.visual_und`."""

    def __init__(self, cfg: G2VLMConfig):
        super().__init__()
        if not cfg.visual_recon:
            raise NotImplementedError("the port covers visual_recon models")
        if cfg.use_dinov3 and cfg.dinov3 is None:
            raise ValueError("use_dinov3 needs cfg.dinov3, a Dinov3Config")
        self.cfg = cfg
        d = cfg.llm.hidden_size
        p = cfg.dino_patch_size
        lm_class = mla_moe_decoder.MLAMoEForCausalLM if cfg.llm.layer_module == "mla_moe" else mot_decoder.MoTForCausalLM
        self.language_model = lm_class(cfg.llm)  # the decoder family: its prefill, decode, cache rows
        if cfg.use_dinov3:
            self.dino_model = dinov3.Dinov3(cfg.dinov3)
            self.dino2llm = nn.Linear(cfg.dinov3.hidden_size, d)
        else:
            self.dino_model = dinov2.Dinov2(cfg.dino)
            self.dino2llm = nn.Linear(cfg.dino.hidden_size, d)
        self.point_decoder = pi3_heads.Decoder(cfg.pi3, d, cfg.pi3.point_out_dim)
        self.point_head = pi3_heads.LinearPts3d(cfg.pi3.point_out_dim, p, 3)
        self.camera_decoder = pi3_heads.Decoder(cfg.pi3, d, cfg.pi3.camera_out_dim)
        self.camera_head = pi3_heads.CameraHead(cfg.pi3.camera_out_dim)
        if cfg.use_global_points:
            self.global_points_decoder = pi3_heads.Decoder(
                cfg.pi3, d, cfg.pi3.point_out_dim, cross=True
            )
            self.global_point_head = pi3_heads.LinearPts3d(cfg.pi3.point_out_dim, p, 3)
        if cfg.train_conf_pi3:
            self.conf_decoder = pi3_heads.Decoder(cfg.pi3, d, cfg.pi3.point_out_dim)
            self.conf_head = pi3_heads.LinearPts3d(cfg.pi3.point_out_dim, p, 1)
            self.Pi3Loss = _Pi3Loss()
        if cfg.visual_und:
            self.vit_model = qwen_vit.QwenVit(cfg.vit)

    def forward(self, fn, *args, **kwargs):
        """`fn(self, *args, **kwargs)`: a whole-model computation (`recon_forward`,
        `trainer.train_forward`) called through the module, where a sharded
        model's root (`parallel.mesh.shard_model`) gathers its parameters."""
        return fn(self, *args, **kwargs)

    @property
    def segformer(self) -> segformer.Segformer:
        return self.Pi3Loss.point_loss.segformer

    @property
    def device(self) -> torch.device:
        return self.dino2llm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.dino2llm.weight.dtype


def encode_dino_to_llm(
    model: G2VLM,
    dino_images: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    remat_group: int = 1,
) -> torch.Tensor:
    """dino_images (N, 3, H, W) RESNET-normalized -> (N*hw, D_llm), in
    `compute_dtype` (default: the parameters' dtype). DINOv3 takes no
    `remat_group`, as in the JAX package."""
    with tracing.span("dino"):
        if model.cfg.use_dinov3:
            tokens = dinov3.encode(model.dino_model, dino_images, compute_dtype, remat=remat)
        else:
            tokens = dinov2.encode(model.dino_model, dino_images, compute_dtype, remat=remat, remat_group=remat_group)
        n, hw, _ = tokens.shape
        return linear(tokens.reshape(n * hw, -1), model.dino2llm, tokens.dtype)


def encode_vit_to_llm(
    model: G2VLM,
    vit_patches: torch.Tensor,  # (P, pdim)
    vit_coords,  # (P, 2) host array or tensor
    vit_seg,  # (P,) host array or tensor; -1 = padding
    attn_impl: str = "auto",
    attn_pipe: bool = False,
) -> torch.Tensor:
    """Packed ViT encode -> (P // 4, D_llm) in the parameters' dtype, chunked
    over rows by `packed_row_chunks` so that the tower's live activations stay
    bounded for many-image prefills."""
    dev = model.device
    with tracing.span("vit"):
        seg_np = vit_seg.cpu().numpy() if isinstance(vit_seg, torch.Tensor) else np.asarray(vit_seg)
        return qwen_vit.encode_packed(
            model.vit_model, vit_patches.to(dev), torch.as_tensor(vit_coords).to(dev),
            torch.as_tensor(seg_np).to(dev), model.dtype, attn_impl, attn_pipe,
            row_chunks=qwen_vit.packed_row_chunks(seg_np),
        )


def prefill_hidden(
    model: G2VLM,
    prefill: PackedPrefill,
    dino_images: Optional[torch.Tensor],
    cfg: G2VLMConfig,
    attn_impl: str = "auto",
    attn_pipe: bool = False,
    vit_patches: Optional[torch.Tensor] = None,
    vit_grid_hw: Optional[Tuple[int, int, int]] = None,
    return_kv: bool = False,
    vit_coords=None,
    vit_seg=None,
    dino_emb: Optional[torch.Tensor] = None,
    vit_emb: Optional[torch.Tensor] = None,
):
    """One packed prefill forward -> hidden (S, D), or with `return_kv`
    (hidden, the layers' cache rows: `LayerKV`s or `LayerLatent`s).

    ViT images enter as one uniform grid (`vit_grid_hw`, a (t, h, w) grid) or
    as packed per-image grids (`vit_coords` / `vit_seg`); `dino_emb` (N*hw,
    D_llm) and `vit_emb` supply tower tokens that were encoded beforehand
    instead of `dino_images` / `vit_patches`. The language model's `prefill`
    runs the layers (the MoT's routing: `MoTForCausalLM.prefill`)."""
    dev, dt = model.device, model.dtype
    lm = model.language_model

    def rows(idx):
        return torch.as_tensor(idx, dtype=torch.long).to(dev)

    if len(prefill.text_ids) and not 0 <= int(np.min(prefill.text_ids)) <= int(np.max(prefill.text_ids)) < cfg.llm.vocab_size:
        raise ValueError(f"token ids outside the vocabulary of {cfg.llm.vocab_size}")
    seq = torch.zeros((len(prefill.doc_id), cfg.llm.hidden_size), dtype=dt, device=dev)
    text_idx = rows(prefill.text_indexes)
    seq[text_idx] = lm.model.embed_tokens(rows(prefill.text_ids)).to(dt)
    if len(prefill.dino_indexes):
        if dino_emb is None and dino_images is not None:
            dino_emb = encode_dino_to_llm(model, dino_images)
        if dino_emb is not None:
            seq[rows(prefill.dino_indexes)] = dino_emb.to(dt)
    n_vit = len(prefill.vit_indexes)
    if n_vit:
        if vit_emb is None and vit_patches is not None:
            if vit_coords is not None:
                vit_emb = encode_vit_to_llm(model, vit_patches, vit_coords, vit_seg, attn_impl, attn_pipe)
            else:
                with tracing.span("vit"):
                    vit_emb = qwen_vit.encode(model.vit_model, vit_patches.to(dev), vit_grid_hw, dt)
        if vit_emb is not None:
            seq[rows(prefill.vit_indexes)] = vit_emb[:n_vit].to(dt)

    return lm.prefill(seq, prefill, prefill.token_info(dev), text_idx, attn_impl, attn_pipe, return_kv)


def pi3_predict(
    model: G2VLM,
    dino_hidden: torch.Tensor,  # (N, hw, D) LLM hidden states at the dino rows
    img_hw: Tuple[int, int],
    cfg: G2VLMConfig,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    view_chunk: int = 0,
) -> Dict[str, torch.Tensor]:
    """The 3D heads; the global decoder cross-attends to frame 0. With
    `cfg.train_conf_pi3` the conf decoder and head add `conf` (N, H, W, 1).

    view_chunk > 0 runs the heads over chunks of that many views (a training
    memory bound): views are independent in the heads' self attention and
    the cross context is always frame 0, so the chunked pass is exact. A
    view count it does not divide takes the unchunked pass."""
    n = dino_hidden.shape[0]
    ctx = dino_hidden[:1]
    if view_chunk and n > view_chunk and n % view_chunk == 0:
        outs = [
            _pi3_predict_full(model, dino_hidden[i : i + view_chunk], img_hw, cfg, ctx, compute_dtype, remat)
            for i in range(0, n, view_chunk)
        ]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
    return _pi3_predict_full(model, dino_hidden, img_hw, cfg, ctx, compute_dtype, remat)


def _pi3_predict_full(
    model: G2VLM,
    dino_hidden: torch.Tensor,
    img_hw: Tuple[int, int],
    cfg: G2VLMConfig,
    global_ctx: torch.Tensor,  # (1, hw, D) frame-0 tokens for the cross decoder
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> Dict[str, torch.Tensor]:
    h, w = img_hw
    p = cfg.dino_patch_size
    hp, wp = h // p, w // p
    n = dino_hidden.shape[0]
    pos = pi3_heads.patch_positions(n, hp, wp, device=dino_hidden.device)

    kw = dict(compute_dtype=compute_dtype, remat=remat)
    point_hidden = pi3_heads.decoder_forward(model.point_decoder, dino_hidden, pos, **kw)
    camera_hidden = pi3_heads.decoder_forward(model.camera_decoder, dino_hidden, pos, **kw)

    ret = pi3_heads.linear_pts3d(model.point_head, point_hidden, (h, w), p)  # (N, H, W, 3)
    xy, z = ret[..., :2], ret[..., 2:]
    z = torch.exp(z)
    local_points = torch.cat([xy * z, z], dim=-1)
    camera_poses = pi3_heads.camera_head(model.camera_head, camera_hidden)  # (N, 4, 4)
    out = {"local_points": local_points, "camera_poses": camera_poses}

    if cfg.use_global_points:
        global_hidden = pi3_heads.decoder_forward(
            model.global_points_decoder, dino_hidden, pos,
            context=global_ctx, context_positions=pos[:1], **kw,
        )
        out["global_points"] = pi3_heads.linear_pts3d(model.global_point_head, global_hidden, (h, w), p)
    if cfg.train_conf_pi3:
        conf_hidden = pi3_heads.decoder_forward(model.conf_decoder, dino_hidden, pos, **kw)
        out["conf"] = pi3_heads.linear_pts3d(model.conf_head, conf_hidden, (h, w), p)

    out["points"] = torch.einsum(
        "nij,nhwj->nhwi", camera_poses, homogenize_points(local_points)
    )[..., :3]
    return out


def recon_forward(
    model: G2VLM,
    prefill: PackedPrefill,
    dino_images: torch.Tensor,  # (N, 3, H, W) RESNET-normalized
    cfg: G2VLMConfig,
    attn_impl: str = "auto",
    attn_pipe: bool = False,
) -> Dict[str, torch.Tensor]:
    """Multi-view reconstruction as one forward: prefill, then the heads."""
    _, _, h, w = dino_images.shape
    hw = (h // cfg.dino_patch_size) * (w // cfg.dino_patch_size)
    n = len(prefill.dino_indexes) // hw
    hidden = prefill_hidden(model, prefill, dino_images, cfg, attn_impl, attn_pipe)
    dino_idx = torch.as_tensor(prefill.dino_indexes, dtype=torch.long).to(hidden.device)
    dino_hidden = hidden[dino_idx].reshape(n, hw, -1)
    with tracing.span("heads"):
        return pi3_predict(model, dino_hidden, (h, w), cfg)
