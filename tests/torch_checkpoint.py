"""Tiny reference-layout checkpoint directories for the port's ingest tests:
text_config.json / vit_config.json / dino_config.json + model.safetensors
(written with the `safetensors` package), and optionally the byte-level BPE
vocabulary of tests/bpe_fixture.py."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from g2vlm_tpu_torch.config import tiny_test_config

# tiny_test_config as G2VLMConfig.from_checkpoint_dir reads it back (the JSON triplet fixes the llm,
# ViT and DINOv2 widths; the Pi3 heads and the top-level flags keep their defaults), with a
# vocabulary wide enough for the pipeline's tokenizer-less prompt ids (< 5,100)
_TINY = tiny_test_config()
CKPT_CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)


def random_state_dict(cfg=CKPT_CFG, seed: int = 0):
    """The port's seeded init with every tensor perturbed (biases, norm gains
    and zero-initialised tokens included), fp32 on the CPU."""
    from g2vlm_tpu_torch.weights import build_model

    g = torch.Generator().manual_seed(seed + 1)
    sd = build_model(cfg, device="cpu", seed=seed).state_dict()
    return {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in sd.items()}


def write_checkpoint(path, state_dict, cfg=CKPT_CFG, vocab: bool = False) -> Path:
    """Write a checkpoint directory at `path`; returns it."""
    from safetensors.torch import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in state_dict.items()}, str(path / "model.safetensors"))
    for name, sub in (("text_config.json", cfg.llm), ("vit_config.json", cfg.vit), ("dino_config.json", cfg.dino)):
        (path / name).write_text(json.dumps(dataclasses.asdict(sub)))
    if vocab:
        from bpe_fixture import train_tiny_bpe

        train_tiny_bpe(str(path))
    return path
