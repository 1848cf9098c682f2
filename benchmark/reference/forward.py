"""The two forwards the benchmark compares the system with: a recon call
(uint8 frames -> points, local_points, global_points, camera_poses) and a
chat request (uint8 frames, a question and the served tokens -> the logits
that chose each served token)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import layout, model, preprocess


def recon(W: Dict[str, torch.Tensor], cfg: Dict, frames: torch.Tensor, new_width: int,
          quant: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """frames (N, H0, W0, 3) uint8 on the reference's device."""
    r = model.Ref(W, cfg, quant)
    p = cfg["dino"]["patch_size"]
    views = preprocess.recon_views(frames, new_width, p)
    n, _, h, w = views.shape
    lay = layout.recon_layout(n, h // p, w // p)
    emb = r.lin(model.dinov2(r, views).reshape(-1, cfg["dino"]["hidden_size"]), "dino2llm")
    hidden = model.decoder(r, model.embed_sequence(r, lay, emb, None, frames.device), lay)
    dino = hidden[torch.as_tensor(lay.dino_indexes, device=frames.device)].reshape(n, -1, hidden.shape[-1])
    return model.pi3_heads(r, dino, (h, w))


def chat_logits(W: Dict[str, torch.Tensor], cfg: Dict, frames: Sequence[np.ndarray], question: str,
                served: Sequence[int], device, quant: Optional[torch.dtype] = None,
                new_width: int = 518) -> torch.Tensor:
    """The logits (len(served), V) at the start token and at every served
    token but the last: row i chose served[i]."""
    r = model.Ref(W, cfg, quant)
    p = cfg["dino"]["patch_size"]
    views = torch.as_tensor(preprocess.chat_views(frames, new_width, p), device=device)
    n, _, h, w = views.shape
    rows = [preprocess.vit_rows(f) for f in frames]
    lay = layout.chat_layout(n, h // p, w // p, [g for _, g in rows], question, served)
    dino = r.lin(model.dinov2(r, views).reshape(-1, cfg["dino"]["hidden_size"]), "dino2llm")
    vit = torch.cat([model.vit(r, torch.as_tensor(x, device=device), g) for x, g in rows])
    hidden = model.decoder(r, model.embed_sequence(r, lay, dino, vit, device), lay)
    return r.lin(hidden[lay.prompt_len:], "language_model.lm_head", bias=False)
