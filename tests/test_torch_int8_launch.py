"""The host side of K8's launch (the int8-QK segment forward, kInt8 of
csrc/attention_segment.cu): the checks `_int8_forward_cuda` makes before it
launches, and the grid it launches, `segment_fwd_grid`'s lockstep block (whose
owners and ring tests/test_torch_segment_launch.py walks at K8's head layouts
too).
CPU only; no card, no jax."""

import pytest
import torch

from g2vlm_tpu_torch.ops import flash_attention as fa


def _operands(s, h, kvh, d):
    """Quantised operands of the shapes K8 takes (values do not matter to the checks)."""
    dp = -(-d // 32) * 32
    meta = torch.zeros((s, 4), dtype=torch.int32)
    return dict(q8=torch.zeros((s, h, dp), dtype=torch.int8), qs=torch.ones((h, s)),
                k8=torch.zeros((s, kvh, dp), dtype=torch.int8), ks=torch.ones((kvh, s)),
                v=torch.zeros((s, kvh, d), dtype=torch.bfloat16), q_meta=meta, kv_meta=meta,
                codes=fa.block_codes(meta, meta))


def _grid(ops):
    return fa._int8_launch_grid(ops["q8"], ops["qs"], ops["k8"], ops["ks"], ops["v"], ops["q_meta"],
                                ops["kv_meta"], ops["codes"])


# (s_q, h, kvh, d, blocks): the chat prefill (756 query tiles, 2 KV heads, their 6 query heads in 2
# blocks of 3) and a ViT chunk (183 query tiles of each of 16 heads in blocks of 3 consecutive tiles),
# and ragged small calls at the other head dims
GRIDS = {
    "chat_prefill": (48384, 12, 2, 128, 756 * 2 * 2),
    "vit_chunk": (11664, 16, 16, 80, 61 * 16),
    "ragged_333_6:2_d96": (333, 6, 2, 96, 6 * 2 * 1),
    "ragged_65_4:2_d64": (65, 4, 2, 64, 1 * 2 * 2),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_k8_launches_the_segment_grid(name):
    s, h, kvh, d, blocks = GRIDS[name]
    got = _grid(_operands(s, h, kvh, d))
    assert got == fa.segment_fwd_grid(s, h, kvh, d, int8=True)[2] == blocks


def _bad(change):
    ops = _operands(130, 4, 2, 80)
    change(ops)
    return ops


def _misaligned(ops):
    buf = torch.zeros(ops["q8"].numel() + 1, dtype=torch.int8)
    ops["q8"] = buf[1:].view(ops["q8"].shape)


BAD = {
    "dp_not_d_rounded_to_32": lambda o: o.update(q8=o["q8"][..., :80].contiguous(),
                                                 k8=o["k8"][..., :80].contiguous()),
    "q8_not_int8": lambda o: o.update(q8=o["q8"].to(torch.int16)),
    "k8_not_contiguous": lambda o: o.update(k8=o["k8"].transpose(0, 1).contiguous().transpose(0, 1)),
    "q8_misaligned": _misaligned,
    "qs_rows_by_heads": lambda o: o.update(qs=o["qs"].T.contiguous()),
    "ks_not_fp32": lambda o: o.update(ks=o["ks"].half()),
    "v_fp32": lambda o: o.update(v=o["v"].float()),
    "head_dim_112": lambda o: o.update(v=torch.zeros((130, 2, 112), dtype=torch.bfloat16),
                                       q8=torch.zeros((130, 4, 128), dtype=torch.int8),
                                       k8=torch.zeros((130, 2, 128), dtype=torch.int8)),
    "heads_not_a_multiple": lambda o: o.update(q8=torch.zeros((130, 3, 96), dtype=torch.int8),
                                               qs=torch.ones((3, 130))),
    "codes_of_another_length": lambda o: o.update(codes=o["codes"][:, :2].contiguous()),
    "codes_not_int8": lambda o: o.update(codes=o["codes"].int()),
    "metadata_of_another_length": lambda o: o.update(kv_meta=o["kv_meta"][:64]),
}


@pytest.mark.parametrize("name", list(BAD))
def test_k8_wrapper_raises_on_what_the_kernel_does_not_take(name):
    assert _grid(_operands(130, 4, 2, 80)) == fa.segment_fwd_grid(130, 4, 2, 80, int8=True)[2]  # the unchanged case passes
    with pytest.raises((ValueError, TypeError)):
        _grid(_bad(BAD[name]))


def test_k8_wrapper_launches_only_on_the_card():
    ops = _operands(130, 4, 2, 80)
    with pytest.raises(ValueError, match="unsupported device"):
        fa._int8_forward_cuda(**ops)
