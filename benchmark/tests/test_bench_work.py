"""The work counts against hand counts and against the bounds of PERF.md's
kernel table (K2 at the recon prefill, K5 at a 12,800-row training pack)."""

import os

import numpy as np
import pytest

from benchmark import core
from benchmark.reference import layout
from benchmark.work import counts

CFG = core.load_json(os.path.join(core.BENCH, "configs", "g2vlm-2b-mot-bf16.json"))


@pytest.mark.parametrize("lay", [
    layout.recon_layout(3, 4, 5),
    layout.chat_layout(2, 3, 4, [(1, 4, 6)] * 2, "a b c d"),
    layout.chat_layout(1, 2, 2, [(1, 4, 4)], "x", served=[5, 6, 7]),
])
def test_closed_form_pairs_equal_the_mask(lay):
    assert lay.visible_pairs() == layout.visible_pairs(lay.info, block=7)


def test_visible_pairs_by_hand():
    # 2 text rows, then 1 view of 2 patches framed: rows 2..5 share one span
    lay = layout.Layout().text([1, 2]).dino_views(1, 1, 2)
    # causal: 6 * 7 / 2 = 21; within the span of 4 rows each sees the later ones: 3 + 2 + 1
    assert lay.visible_pairs() == 21 + 6


def test_k2_bound_at_the_recon_prefill():
    """PERF.md: K2 at (25088, 12:2, 128) is bound by 3.861 ms of operations."""
    w = counts.recon_work(CFG, 32, 21, 37)
    assert w["k2_bound_s"] / 28 * 1e3 == pytest.approx(3.8612, abs=5e-4)


def test_k5_bounds_at_the_training_pack():
    """PERF.md: K5 at (12800, 12:2, 128) (31 text rows and 16 views of 294x518) is
    bound by 1.451 ms for dq and 1.935 ms for dkv."""
    lay = layout.Layout().text(range(31)).dino_views(16, 21, 37)
    dq, dkv = counts.backward_bounds_s(lay.visible_pairs(), 12, 128, 12800, 2)
    assert dq * 1e3 == pytest.approx(1.451, abs=5e-4)
    assert dkv * 1e3 == pytest.approx(1.935, abs=5e-4)


def test_attention_bound_by_hand():
    # 1e9 pairs, 1 head of 128, 2 products: 5.12e11 operations over 989e12
    assert counts.attention_bound_s(1e9, 1, 128, 2, 10, 10, 1, 2, 2) == pytest.approx(5.12e11 / 989e12)
    # 4 rows and keys: bytes win, 2 * 128 * (2 * 4 + 2 * 4) bytes over 3.35e12
    assert counts.attention_bound_s(4, 1, 128, 2, 4, 4, 1, 2, 2) == pytest.approx(4096 / 3.35e12)


def test_dinov2_flops_by_hand():
    cfg = {"dino": {"hidden_size": 8, "patch_size": 2, "num_register_tokens": 1, "mlp_ratio": 4,
                    "num_hidden_layers": 1}, "llm": {"hidden_size": 3}}
    t = 1 + 1 + 2 * 3  # cls, register, 2 x 3 patches
    layer = 2 * t * 8 * (4 * 8 + 2 * 32) + 4 * t * t * 8
    assert counts.dinov2_flops(cfg, 1, 2, 3) == 2 * 6 * 12 * 8 + layer + 2 * 6 * 8 * 3


def test_a_recon_call_is_about_215_tflop():
    # ~107 attention over the visible pairs, ~66 decoder products, ~17 DINOv2, ~25 the heads
    w = counts.recon_work(CFG, 32, 21, 37)
    assert 2.10e14 < w["flops"] < 2.20e14
    assert 1.6e13 < counts.dinov2_flops(CFG, 32, 21, 37) < 1.8e13


def test_chat_work_grows_with_views_and_tokens():
    a = counts.chat_work(CFG, 1, 28, 37, 30, 8)
    b = counts.chat_work(CFG, 4, 28, 37, 30, 8)
    c = counts.chat_work(CFG, 4, 28, 37, 30, 64)
    assert a["flops"] < b["flops"] < c["flops"] and a["k2_bound_s"] < b["k2_bound_s"] == c["k2_bound_s"]
    # 56 more decode steps each read the 152k x 1536 head at least
    assert c["flops"] - b["flops"] > 56 * 2 * 1536 * 151936
    assert np.isclose(b["tokens"], 8)
