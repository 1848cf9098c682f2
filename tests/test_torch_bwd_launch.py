"""The host side of the backward kernels' launch (csrc/attention_bwd.cu):
the grids `bwd_blocks` reckons and the cut of the GQA group into slices that
`dkv_head_split` chooses for the dkv kernel. CPU only; no card, no jax."""

import pytest

from g2vlm_tpu_torch.ops import flash_attention as fa

H100_SMS = 132
# (n_q, n_kv_store, h, kvh, batch): K5 at the 16-view training pack, K7 at the DINOv2 and Pi3
# training batches, a ragged segment call with an odd group, a small batched call
SHAPES = {
    "k5_train_pack": (12800, 12800, 12, 2, 1),
    "k7_dinov2": (782, 782, 16, 16, 16),
    "k7_pi3": (777, 777, 16, 16, 16),
    "odd_group_ragged": (77, 77, 6, 2, 1),
    "small_batched": (65, 63, 1, 1, 2),
}


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_bwd_blocks_give_every_output_row_one_owner(shape):
    """Each dq block owns 2 x 64 (query row, head) pairs and each dkv block 2 x 64 key rows of one
    KV head and slice: the grids cover every output row once, with less than one tile to spare per
    head pair or KV head."""
    n_q, n_kv, h, kvh, batch = shape
    group = h // kvh
    for n_split in [s for s in range(1, group + 1) if group % s == 0]:
        dq_blocks, dkv_blocks = fa.bwd_blocks(n_q, n_kv, h, kvh, batch, n_split)
        q_tiles = -(-n_q // fa.TILE)
        assert dq_blocks * 2 >= q_tiles * h * batch
        assert (dq_blocks * 2 - q_tiles * h * batch) < 2 * kvh * group * batch  # at most one spare tile per pair
        assert dkv_blocks * fa.BWD_KEYS_PER_BLOCK >= n_kv * kvh * n_split * batch
        assert dkv_blocks == -(-n_kv // fa.BWD_KEYS_PER_BLOCK) * kvh * n_split * batch


def test_dq_blocks_share_a_kv_stage_between_two_heads_of_a_group():
    # 12:2 heads: 200 q tiles x 2 KV heads x 3 pairs of query heads
    assert fa.bwd_blocks(12800, 12800, 12, 2, 1, 1)[0] == 200 * 2 * 3
    # a group of one (K7): one head, two q tiles per block
    assert fa.bwd_blocks(782, 782, 16, 16, 16, 1)[0] == 7 * 16 * 16


@pytest.mark.parametrize(
    "shape,n_sm,want",
    [
        (SHAPES["k5_train_pack"], H100_SMS, 3),  # 200 blocks: 2 waves unsplit, 5 waves of a third cut in 3
        (SHAPES["k7_dinov2"], H100_SMS, 1),  # a group of one cannot be cut
        ((12800, 12800, 12, 2, 8), H100_SMS, 1),  # 1,600 blocks: 13 waves, at best 12.2 cut: not worth it
        ((12800, 12800, 12, 2, 1), 100, 1),  # 200 blocks are exactly two waves on 100 SMs
        ((4096, 4096, 8, 1, 1), H100_SMS, 4),  # 32 blocks, one short wave: 4 slices fit in one wave too
    ],
)
def test_dkv_head_split_fills_the_card(shape, n_sm, want):
    n_q, n_kv, h, kvh, batch = shape
    assert fa.dkv_head_split(n_q, n_kv, h, kvh, batch, n_sm) == want


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("n_sm", [1, 78, 114, 132])
def test_dkv_head_split_is_the_smallest_split_near_the_fewest_waves(shape, n_sm):
    n_q, n_kv, h, kvh, batch = shape
    group = h // kvh
    splits = [s for s in range(1, group + 1) if group % s == 0]

    def waves(s):  # in units of the time of one unsplit block
        return -(-fa.bwd_blocks(n_q, n_kv, h, kvh, batch, s)[1] // n_sm) / s

    got = fa.dkv_head_split(n_q, n_kv, h, kvh, batch, n_sm)
    assert got in splits
    fewest = min(waves(s) for s in splits)
    assert waves(got) <= fewest * (1 + fa.SPLIT_SLACK)
    assert all(waves(s) > fewest * (1 + fa.SPLIT_SLACK) for s in splits if s < got)
