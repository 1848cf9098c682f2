"""Inference pipelines (port of g2vlm_tpu/inference/pipeline.py).

Recon: `recon` takes image paths, PIL images or arrays, decodes and resizes
them on the host (PIL, LANCZOS) and returns numpy outputs with the [0, 1]
views. `recon_from_frames` takes decoded uint8 frames, moves them to the
model's device once, preprocesses them there and runs the packed prefill and
the heads, returning the outputs on the device.

Chat with the reconstruction in context: system prompt -> dino (geometry)
views -> per-image ViT tokens -> question, all in ONE packed prefill whose
per-layer K/V fill a preallocated cache, then the decode loop of
inference/decoding.py. `chat` takes images (host preprocess, any shapes) or,
with `device_preprocess`, uniform uint8 frames that are uploaded once and
preprocessed for both towers on the device, the towers encoding view chunks
one after another. `chat_continue` runs a follow-up turn on the live cache.

Serving options, fixed at construction: `attn_impl` "auto" or "int8" (the
quantized serving mode: every large prefill attention of the ViT tower and of
the decoder takes the int8-QK kernel), and `attn_pipe` (the two-stage schedule
of the segment kernel); the language model refuses what its family does not take.
"""

from __future__ import annotations

import contextlib
import functools
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import G2VLMConfig
from ..data.device_preprocess import (
    preprocess_views_device, preprocess_vit_frames_device, target_hw, vit_device_grid,
)
from ..data.images import load_views, resnet_normalize
from ..data.tokenizer import derive_start_token
from ..data.vit_preprocess import preprocess_vit_image
from ..models import qwen_vit
from ..models.g2vlm import (
    G2VLM, PackedPrefill, SequenceBuilder, encode_dino_to_llm, encode_vit_to_llm, prefill_hidden, recon_forward,
)
from ..parallel.mesh import model_mesh
from ..utils import tracing
from . import decoding

RECON_PROMPT = "Reconstruct the 3D scene."
UPLOAD_CHUNKS = 4  # view chunks of the device-preprocess chat path


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ChatSession(NamedTuple):
    """Live multi-turn chat state. The cache is updated in place by
    `chat_continue`: use each session object at most once."""

    cache: decoding.KVCache
    next_rope_pos: int
    pending_token: int  # emitted but not yet consumed (eos on a clean stop)
    capacity: int
    quantized_kv: bool


def _inference(fn):
    """`torch.inference_mode` around a recon call, `torch.no_grad` on a
    sharded model (`parallel.mesh.shard_model`): FSDP2's parameter gathers
    need version counters, which inference tensors lack."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with torch.no_grad() if model_mesh(self.model) is not None else torch.inference_mode():
            return fn(self, *args, **kwargs)

    return run


class G2VLMPipeline:
    """Owns the model, the config and the serving options for recon and chat."""

    SYSTEM_PROMPT = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n"

    def __init__(
        self,
        model: G2VLM,
        cfg: G2VLMConfig,
        tokenizer=None,
        new_token_ids: Optional[Dict[str, int]] = None,
        attn_impl: str = "auto",
        attn_pipe: bool = False,
        seq_pad_multiple: int = 256,
    ):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids or dict(
            bos_token_id=151644, eos_token_id=151645,
            start_of_image=151652, end_of_image=151653,
        )
        if attn_impl not in ("auto", "int8"):
            raise ValueError(f"unknown attention impl: {attn_impl}")
        if model is not None:  # without a model the pipeline only builds prefills
            model.language_model.check_serving(attn_impl, attn_pipe)
        self.attn_impl = attn_impl
        self.attn_pipe = attn_pipe
        self.seq_pad_multiple = seq_pad_multiple

    @property
    def _attn(self) -> Dict:
        return dict(attn_impl=self.attn_impl, attn_pipe=self.attn_pipe)

    def _encode_text(self, text: str, add_bos: bool = False) -> List[int]:
        if self.tokenizer is None:
            # deterministic ids for runs without vocabulary files (crc32, not
            # hash(): str hash is randomized per process)
            ids = [(zlib.crc32(w.encode()) % 5000) + 100 for w in text.split()]
        else:
            ids = self.tokenizer.encode(text)
        if add_bos:
            ids = [self.new_token_ids["bos_token_id"]] + ids
        return ids

    def _decode_text(self, ids) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode(list(ids))

    def _start_token(self) -> int:
        return derive_start_token(self.tokenizer, self.new_token_ids)

    # ------------------------------------------------------------------
    # recon
    # ------------------------------------------------------------------
    def build_recon_prefill(self, n_views: int, hp: int, wp: int, prompt: str = RECON_PROMPT) -> PackedPrefill:
        b = SequenceBuilder(self.new_token_ids["start_of_image"], self.new_token_ids["end_of_image"])
        b.add_text(self._encode_text(prompt, add_bos=True))
        b.add_dino_images(n_views, hp, wp)
        return b.build(pad_to=_round_up(b.curr, self.seq_pad_multiple))

    def _recon(self, normed: torch.Tensor, prompt: str) -> Dict[str, torch.Tensor]:
        n, _, h, w = normed.shape
        p = self.cfg.dino_patch_size
        prefill = self.build_recon_prefill(n, h // p, w // p, prompt)
        return self.model(recon_forward, prefill, normed.to(self.model.dtype), self.cfg, **self._attn)

    def recon(self, images: Sequence, prompt: str = RECON_PROMPT, new_width: int = 518) -> Dict[str, np.ndarray]:
        """Image paths / PIL images / HWC uint8 arrays -> dict(points,
        local_points, camera_poses, global_points) as fp32 numpy, plus
        "images": the (N, 3, H, W) [0, 1] views. Decoding and the LANCZOS
        resize run on the host (`load_views`), the model on its device."""
        views = load_views(images, new_width=new_width)
        out = {k: v.float().cpu().numpy() for k, v in self.recon_from_views(views, prompt=prompt).items()}
        out["images"] = views
        return out

    @_inference
    def recon_from_views(self, views: np.ndarray, prompt: str = RECON_PROMPT) -> Dict[str, torch.Tensor]:
        """Recon on preloaded [0, 1] views (N, 3, H, W); outputs stay on the device."""
        with tracing.span("recon"):
            with tracing.span("input"):
                normed = self._upload(resnet_normalize(views), torch.float32)
            return self._recon(normed, prompt)

    @_inference
    def recon_from_frames(
        self,
        frames,  # (N, H0, W0, 3) uint8 decoded frames, numpy or tensor
        prompt: str = RECON_PROMPT,
        new_width: int = 518,
    ) -> Dict[str, torch.Tensor]:
        """Recon straight from uint8 frames: one upload of the raw bytes, then
        cast -> antialiased bilinear resize -> RESNET normalisation -> packed
        prefill -> heads on the device. Returns points, local_points,
        camera_poses and global_points on the device."""
        with tracing.span("recon"):
            with tracing.span("input"):
                frames = self._upload(frames)
                n, h0, w0, _ = frames.shape
                th, tw = target_hw(h0, w0, new_width, self.cfg.dino_patch_size)
                normed = preprocess_views_device(frames, (th, tw))
            return self._recon(normed, prompt)

    # ------------------------------------------------------------------
    # chat with the reconstruction in context
    # ------------------------------------------------------------------
    def build_chat_prefill(self, n_views: int, hp: int, wp: int, vit_grids, prompt: str) -> PackedPrefill:
        b = SequenceBuilder(self.new_token_ids["start_of_image"], self.new_token_ids["end_of_image"])
        b.add_text(self._encode_text(self.SYSTEM_PROMPT))
        b.add_dino_images(n_views, hp, wp)
        for _, gh, gw in vit_grids:
            b.add_vit_image(gh // 2, gw // 2)
        b.add_text(self._encode_text(prompt + "<|im_end|>\n<|im_start|>assistant"))
        return b.build(pad_to=_round_up(b.curr, self.seq_pad_multiple))

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _upload(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Request data (an array or tensor) -> the model's device, in `dtype`
        (default: its own), counted in `upload.bytes` when it comes from host
        memory: its elements at the dtype it is sent in (a blocking copy casts
        on the host first)."""
        t = torch.as_tensor(x)
        if t.device.type == "cpu":
            tracing.count("upload.bytes", t.numel() * (dtype or t.dtype).itemsize)
        return t.to(device=self.model.device, dtype=dtype)

    @staticmethod
    def _uniform_frames(images) -> Optional[np.ndarray]:
        """The images as one (N, H, W, 3) uint8 array when they are uniform
        uint8 RGB frames, else None (the caller takes the host path)."""
        def to_rgb_u8(im):
            if isinstance(im, (np.ndarray, torch.Tensor)):
                return np.asarray(im)
            from PIL import Image  # only paths and PIL images need it

            if isinstance(im, str):
                im = Image.open(im)
            return np.asarray(im.convert("RGB"))

        arrs = [to_rgb_u8(im) for im in images]
        ok = len({a.shape for a in arrs}) == 1 and all(
            a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 3 for a in arrs)
        return np.stack(arrs) if ok else None

    def _encode_frames(self, frames: np.ndarray, hw):
        """Upload uniform uint8 frames and encode both towers, in UPLOAD_CHUNKS
        view chunks when the view count allows: (dino_emb, vit_emb)."""
        model, dt = self.model, self.model.dtype
        n = frames.shape[0]
        chunks = UPLOAD_CHUNKS if n % UPLOAD_CHUNKS == 0 and n >= 2 * UPLOAD_CHUNKS else 1
        nc = n // chunks
        grid = vit_device_grid()
        coords = np.concatenate([qwen_vit.merge_permuted_hw_coords(grid)] * nc)
        seg = np.repeat(np.arange(nc, dtype=np.int32), int(np.prod(grid)))
        dino_embs, vit_embs = [], []
        for i in range(chunks):
            part = self._upload(frames[i * nc : (i + 1) * nc])
            views = preprocess_views_device(part, hw)
            dino_embs.append(encode_dino_to_llm(model, views.to(dt)))
            patches = preprocess_vit_frames_device(part, out_dtype=dt)
            vit_embs.append(encode_vit_to_llm(model, patches, coords, seg, **self._attn))
        return torch.cat(dino_embs), torch.cat(vit_embs)

    @torch.inference_mode()
    def chat_prefill(
        self,
        images: Sequence,
        prompt: str,
        new_width: int = 518,
        device_preprocess: bool = False,
        timed: bool = False,
    ):
        """The prefill of a chat call: both image preprocesses, both towers
        and one packed forward. Returns (prefill, hidden (S, D) in logical row
        order, the layers' LayerKV list in sorted row order, n_views,
        (t_upload_s, t_forward_s)); the two times are None unless `timed`,
        which records the call's spans (`tracing.record()`), synchronises the
        device at the end of the `upload` and `prefill` stages and returns
        their host durations."""
        model, dt = self.model, self.model.dtype
        p = self.cfg.dino_patch_size
        frames = self._uniform_frames(images) if device_preprocess else None
        normed = None
        with tracing.record() if timed else contextlib.nullcontext():
            if frames is not None:
                n, h0, w0, _ = frames.shape
                h, w = target_hw(h0, w0, new_width, p)
                prefill = self.build_chat_prefill(n, h // p, w // p, [vit_device_grid()] * n, prompt)
                with tracing.span("upload") as upload:
                    towers = dict(zip(("dino_emb", "vit_emb"), self._encode_frames(frames, (h, w))))
                    if timed:
                        self._sync()
            else:
                with tracing.span("host_images"):
                    views = load_views(images, new_width=new_width)
                    vit_inputs = [preprocess_vit_image(im) for im in images]
                    n_pat = sum(int(np.prod(g)) for _, g in vit_inputs)
                    vit_patches, vit_coords, vit_seg, _ = qwen_vit.pack_views(
                        [{"patches": pats, "grid_thw": grid} for pats, grid in vit_inputs], pad_to=_round_up(n_pat, 8))
                n, _, h, w = views.shape
                prefill = self.build_chat_prefill(n, h // p, w // p, [g for _, g in vit_inputs], prompt)
                with tracing.span("upload") as upload:
                    normed = self._upload(resnet_normalize(views), dt)
                    towers = dict(vit_patches=self._upload(vit_patches, dt), vit_coords=vit_coords, vit_seg=vit_seg)
                    if timed:
                        self._sync()
            with tracing.span("prefill") as forward:
                hidden, kv = prefill_hidden(model, prefill, normed, self.cfg, return_kv=True, **towers, **self._attn)
                del normed, towers
                if timed:
                    self._sync()
        return prefill, hidden, kv, n, (upload.host_s, forward.host_s) if timed else (None, None)

    @torch.inference_mode()
    def chat(
        self,
        images: Sequence,
        prompt: str,
        max_new_tokens: int = 100,
        do_sample: bool = False,
        temperature: float = 1.0,
        new_width: int = 518,
        seed: int = 0,
        return_info: bool = False,
        quantized_kv: bool = False,
        return_session: bool = False,
        session_reserve: int = 2048,  # extra cache capacity for follow-up turns
        device_preprocess: bool = False,
    ):
        """Images + question -> answer text (the token ids joined by spaces
        when there is no tokenizer). With `return_session` (text, ChatSession);
        else with `return_info` (text, info) where info has the token ids, the
        id of the call's request in `tracing` (`tracing.record()` is on for the
        call) and the host durations of its stage spans, each stage ending in
        a device synchronisation: upload (+ towers on the device-preprocess
        path), the prefill forward, the cache build, and the decode loop.

        `device_preprocess`: upload raw uint8 frames once and run both image
        preprocesses on the device; needs uniform uint8 frames (else the host
        path runs), and deviates from the PIL host path at serving tolerance."""
        model, dev, dt = self.model, self.model.device, self.model.dtype
        with tracing.record() if return_info else contextlib.nullcontext(), tracing.span("chat") as call:
            prefill, _, kv, n, (t_upload, t_forward) = self.chat_prefill(
                images, prompt, new_width, device_preprocess, timed=return_info)
            with tracing.span("cache") as cache_span:
                reserve = session_reserve if return_session else 0
                capacity = max(_round_up(prefill.seq_len + max_new_tokens + reserve + 8, 128), len(prefill.doc_id))
                # only the first seq_len rows are valid K/V (the padding sits at the tail and the length
                # hides it); build_cache consumes the list, so the prefill K/V is freed layer by layer
                cache = decoding.build_cache(kv, prefill.seq_len, self.cfg.llm, capacity, dtype=dt,
                                             quantized=quantized_kv)
                del kv
                if return_info:
                    self._sync()
            with tracing.span("decode") as decode_span:
                start_token = self._start_token()
                eos = self.new_token_ids["eos_token_id"]
                decode_pos = model.language_model.decode_pos(prefill)
                generator = torch.Generator(device=dev).manual_seed(seed) if do_sample else None
                toks, num, cache = decoding.generate(
                    model.language_model, cache, start_token, decode_pos, eos, self.cfg.llm,
                    max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature,
                    generator=generator, compute_dtype=dt,
                )
                num = int(num)  # reads the device: the loop is over
            ids = toks[:num].tolist()
            session = None
            if return_session:
                # the position advanced by the consumed tokens: the start token and
                # num - 1 generated ones; the last emitted token (eos on a clean
                # stop) was never consumed, chat_continue feeds it first
                session = ChatSession(cache, int(decode_pos) + num, ids[-1] if ids else start_token,
                                      capacity, quantized_kv)
            if ids and ids[-1] == eos:
                ids = ids[:-1]
            text = self._decode_text(ids)
        if return_session:
            return text, session
        if return_info:
            t_cache, t_decode = cache_span.host_s, decode_span.host_s
            return text, {
                "token_ids": toks[:num].tolist(),
                "num_tokens": num,
                "prefill_len": int(prefill.seq_len),
                "n_views": int(n),
                "request_id": call.rid,
                "t_prefill_s": t_upload + t_forward + t_cache,
                "t_upload_s": t_upload,
                "t_forward_s": t_forward,
                "t_cache_s": t_cache,
                "t_decode_s": t_decode,
            }
        return text

    @torch.inference_mode()
    def chat_continue(
        self,
        session: ChatSession,
        prompt: str,
        max_new_tokens: int = 100,
        do_sample: bool = False,
        temperature: float = 1.0,
        seed: int = 0,
    ):
        """A follow-up turn on a live session from chat(return_session=True):
        len(turn) decode steps against the resident cache instead of a fresh
        multi-view prefill. Returns (text, new_session); `session` is
        consumed (its cache is extended in place)."""
        ids = [session.pending_token] + self._encode_text(
            "\n<|im_start|>user\n" + prompt + "<|im_end|>\n<|im_start|>assistant")
        n = len(ids)
        need = n + max_new_tokens + 2
        have = session.capacity - (session.next_rope_pos + 1)
        if need > have:
            raise ValueError(
                f"chat session cache exhausted (turn needs {need} rows, {have} free of {session.capacity}); "
                f"start a new chat with a larger session_reserve")
        lm, dt = self.model.language_model, self.model.dtype
        dev = self.model.device
        _, cache = decoding.extend_cache(lm, session.cache, ids, session.next_rope_pos, self.cfg.llm,
                                         compute_dtype=dt)
        start_token = self._start_token()
        eos = self.new_token_ids["eos_token_id"]
        generator = torch.Generator(device=dev).manual_seed(seed) if do_sample else None
        toks, num, cache = decoding.generate(
            lm, cache, start_token, session.next_rope_pos + n, eos, self.cfg.llm,
            max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature,
            generator=generator, compute_dtype=dt,
        )
        num = int(num)
        out = toks[:num].tolist()
        new_session = session._replace(
            cache=cache, next_rope_pos=session.next_rope_pos + n + num, pending_token=out[-1] if out else start_token)
        if out and out[-1] == eos:
            out = out[:-1]
        return self._decode_text(out), new_session

