"""Tokenizer loading (the port's own copy of g2vlm_tpu/data/tokenizer.py,
which it does not import). Tokenization is host work: the Qwen2 BPE of
`transformers` is reused. Without vocabulary files the pipeline runs on its
tokenizer-less ids and `derive_start_token` gives the eos id."""

from __future__ import annotations

from typing import Dict, Tuple

SPECIAL_TOKENS = ["<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>"]


def load_tokenizer(path: str) -> Tuple[object, Dict[str, int], int]:
    """-> (tokenizer, new_token_ids, num_added). new_token_ids has
    bos_token_id (<|im_start|>), eos_token_id (<|im_end|>), start_of_image
    (<|vision_start|>) and end_of_image (<|vision_end|>). Needs the
    `transformers` package, and raises ImportError naming it where it is
    missing: a run with vocabulary files never falls back to the
    tokenizer-less ids, which would change every prompt."""
    try:
        from transformers import Qwen2Tokenizer
    except ImportError as e:
        raise ImportError(f"load_tokenizer needs the `transformers` package (its Qwen2 BPE) to read the "
                          f"vocabulary in {path}: {e}") from e

    tokenizer = Qwen2Tokenizer.from_pretrained(path)
    existing = set()
    for v in tokenizer.special_tokens_map.values():
        if isinstance(v, str):
            existing.add(v)
        else:
            existing.update(v)
    new = [t for t in SPECIAL_TOKENS if t not in existing]
    num_added = tokenizer.add_tokens(new)
    ids = {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS}
    new_token_ids = dict(
        bos_token_id=ids["<|im_start|>"],
        eos_token_id=ids["<|im_end|>"],
        start_of_image=ids["<|vision_start|>"],
        end_of_image=ids["<|vision_end|>"],
    )
    return tokenizer, new_token_ids, num_added


# the decode start token is the LAST id of this template encoded without
# special tokens: with the production Qwen2 vocabulary the trailing newline (id 198)
START_TOKEN_TEMPLATE = (
    "<|im_start|>user\\your text<|im_end|>\n<|im_start|>assistant\n"
)


def derive_start_token(tokenizer, new_token_ids: Dict[str, int]) -> int:
    """The decode start token; tokenizer-less runs take the eos id."""
    if tokenizer is None:
        return new_token_ids["eos_token_id"]
    ids = tokenizer.encode(START_TOKEN_TEMPLATE, add_special_tokens=False)
    if ids:
        return ids[-1]
    return getattr(tokenizer, "eos_token_id", None) or 151643
