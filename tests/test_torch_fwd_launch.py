"""The host side of the batched forward's launch (K1 / K6,
csrc/attention_batched.cu): the items and the persistent grid that
`batched_fwd_grid` reckons. The walk below reads the rows of an item as its
docstring says: item i of a view holds rows [i rows_per_block, (i + 1)
rows_per_block), 64 for each consumer warpgroup. CPU only; no card, no jax."""

import numpy as np
import pytest

from g2vlm_tpu_torch.ops import flash_attention as fa

H100_SMS = 132
# (b, s, h): K1 at the DINOv2-L and Pi3 view batches of a recon call, K6 at the 16-view training batch,
# and two ragged small calls (S 65 / M 63, S 17 / M 130; the schedule does not depend on M: every
# item walks all keys)
SHAPES = {
    "k1_dinov2": (32, 782, 16),
    "k1_pi3": (32, 777, 16),
    "k6_dinov2": (16, 782, 16),
    "ragged_s65_m63": (2, 65, 1),
    "ragged_s17_m130": (2, 17, 2),
}
# query rows of a block: two warpgroups at head dims 64 and 128, three at 96 (FwdConfig)
ROWS_PER_BLOCK = {"wg2": 128, "wg3": 192}


@pytest.mark.parametrize("n_sm,per_sm", [(H100_SMS, 1), (H100_SMS, 2), (7, 1)])
@pytest.mark.parametrize("rows_per_block", list(ROWS_PER_BLOCK.values()), ids=list(ROWS_PER_BLOCK))
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_every_query_row_has_one_owner(shape, rows_per_block, n_sm, per_sm):
    b, s, h = shape
    items, blocks = fa.batched_fwd_grid(b, s, h, rows_per_block, n_sm, per_sm)
    n_qb = -(-s // rows_per_block)  # query blocks of a view
    assert items == b * h * n_qb
    assert blocks == min(items, n_sm * per_sm)
    owners = np.zeros((b, h, s), dtype=np.int64)
    per_block = np.zeros(blocks, dtype=np.int64)
    padding = []  # rows past s of each warpgroup that has rows; a warpgroup without rows skips its products
    for blk in range(blocks):
        for item in range(blk, items, blocks):
            per_block[blk] += 1
            bh, qb = divmod(item, n_qb)
            for q0 in range(qb * rows_per_block, (qb + 1) * rows_per_block, fa.TILE):
                n = max(0, min(fa.TILE, s - q0))
                owners[bh // h, bh % h, q0:q0 + n] += 1
                if n:
                    padding.append(fa.TILE - n)
    assert (owners == 1).all()
    # the padding: less than one 64-row tile per warpgroup, and only in the last tile of a view
    assert max(padding) < fa.TILE
    assert sum(p > 0 for p in padding) == (b * h if s % fa.TILE else 0)
    # every block walks its items in turn, and the blocks share them evenly
    assert per_block.max() - per_block.min() <= 1 and per_block.sum() == items


def test_batched_fwd_grid_at_the_main_path_shapes():
    # DINOv2-L: 13 tiles of 64 rows in 7 blocks of two warpgroups, 32 x 16 (b, h), two blocks an SM
    assert fa.batched_fwd_grid(32, 782, 16, 128, H100_SMS, 2) == (32 * 16 * 7, 2 * H100_SMS)
    # Pi3 at head dim 96: 13 tiles in 5 blocks of three warpgroups
    assert fa.batched_fwd_grid(32, 777, 16, 192, H100_SMS, 1) == (32 * 16 * 5, H100_SMS)
    # a call with fewer items than the card holds blocks launches one block per item
    assert fa.batched_fwd_grid(2, 65, 1, 128, H100_SMS, 2) == (2, 2)
