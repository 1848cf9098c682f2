"""What the command-line tools of the port share: the pipeline that a
checkpoint directory or smoke mode (random weights from a seed) gives."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import G2VLMConfig, tiny_test_config
from .data.tokenizer import load_tokenizer
from .inference.pipeline import G2VLMPipeline
from .weights import build_model, load_checkpoint


def pipeline_for_cli(
    model_path: Optional[str],
    tiny: bool = False,
    visual_und: bool = True,
    device: str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    **options,
) -> G2VLMPipeline:
    """The pipeline of the command-line tools. With `model_path`, the
    checkpoint directory (strict load onto `device` in `dtype`) and its
    vocabulary (`load_tokenizer`, which needs `transformers`). Without, random
    weights from `seed` (smoke mode) for `G2VLMConfig(visual_und)` or, with
    `tiny`, `tiny_test_config(visual_und)` with the vocabulary widened to
    5,120 and small special ids: the tokenizer-less prompt ids reach 5,100,
    the default special ids 151,653, and an id past the table raises.
    `options` go to the pipeline (attn_impl, attn_pipe)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs an NVIDIA GPU; pass --device cpu for the CPU")
    if model_path:
        model, cfg = load_checkpoint(model_path, device=device, dtype=dtype)
        tokenizer, new_token_ids, _ = load_tokenizer(model_path)
        return G2VLMPipeline(model, cfg, tokenizer=tokenizer, new_token_ids=new_token_ids, **options)
    print("no --model_path: using random weights (smoke mode)")
    new_token_ids = None
    if tiny:
        cfg = tiny_test_config(visual_und)
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=5120))
        new_token_ids = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
    else:
        cfg = G2VLMConfig(visual_und=visual_und)
    model = build_model(cfg, device=device, dtype=dtype, seed=seed)
    return G2VLMPipeline(model, cfg, new_token_ids=new_token_ids, **options)
