"""Tiny sizes for the CPU tests of the benchmark: the configuration's
structure at small widths (with the full vocabulary, so that the system's
special token ids fit) and small versions of each traffic mix."""

import dataclasses
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MIX = {
    "recon-32v": {"views": 2, "height": 28, "width": 56, "new_width": 56, "scenes": 2, "check_calls": 1,
                  "warmup": 1},
    "chat-short": {"views": [1, 2], "bands": 2, "block": 4, "height": 48, "width": 64, "pool_frames": 4,
                   "question_words": [3, 6], "max_new_tokens": [12, 24], "check_requests": 4, "check_tokens": 64},
}


def tiny_config(dtype: str = "bfloat16") -> dict:
    from g2vlm_tpu_torch.config import tiny_test_config

    d = json.loads(json.dumps(dataclasses.asdict(tiny_test_config())))
    d.pop("dinov3")
    d["llm"]["vocab_size"] = 151936
    d["dtype"] = dtype
    return d


@pytest.fixture
def tiny():
    def overrides(cell: str, dtype: str = "bfloat16") -> dict:
        return {"config": tiny_config(dtype), "mix": TINY_MIX[cell]}

    return overrides
