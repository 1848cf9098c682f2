"""The host side of the segment forwards' launch (K2 / K3 / K4 / K8,
csrc/attention_segment.cu): the grid that `segment_fwd_grid` reckons and the
wrapper launches, the warpgroups that `segment_fwd_blocks` gives each block
(the kernel's `block_plan`), and the K/V tiles that enter a block's ring: every
tile that some warpgroup's code does not mark SKIP (the lockstep schedule's
`issue_next`, the warp-specialised producer's loop). Both blocks: three
warpgroups (the lockstep schedule: K4, K8 and K2 / K3 below head dim 128) and
two (K2 / K3's warp-specialised schedule at head dim 128). CPU only; no card,
no jax."""

import numpy as np
import pytest
import torch

from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.data.device_preprocess import vit_device_grid
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.models.g2vlm import split_order
from g2vlm_tpu_torch.ops import flash_attention as fa
from g2vlm_tpu_torch.ops.masks import TokenInfo, make_segment_mask, make_token_info

# (s_q, h, kvh): K2 at the recon and chat prefills, K3 at the training pack, K2 (and K8 with
# attn_impl="int8") at the chat prefill and a ViT chunk, and ragged small calls
SHAPES = {
    "recon_prefill": (25088, 12, 2),
    "chat_prefill": (48384, 12, 2),
    "train_pack": (12800, 12, 2),
    "vit_chunk": (11664, 16, 16),
    "ragged_333": (333, 4, 2),
    "ragged_333_6:2": (333, 6, 2),
    "ragged_65": (65, 2, 1),
    "ragged_65_16:16": (65, 16, 16),
}
WGS = fa.SEGMENT_WARPGROUPS  # the lockstep block: heads of a group where it is a multiple of them, else query tiles
# (head dim, pipelined): the lockstep block below head dim 128 and of K4, the warp-specialised one of K2 / K3
BLOCKS = {"d80": (80, False), "d128": (128, False), "d128_k4": (128, True)}
# the packs of tests/test_torch_ops.py::test_block_codes_match_jax
CODE_CASES = [
    dict(sample_lens=[96], split_lens=[96], modes=["causal"]),
    dict(sample_lens=[100, 156], split_lens=[40, 60, 56, 100], modes=["causal", "full", "causal", "full"]),
    dict(sample_lens=[70, 130], split_lens=[30, 40, 50, 80], modes=["causal", "noise", "full", "noise"], pad_to=237),
]


def _check_owners(name, d, pipelined):
    s_q, h, kvh = SHAPES[name]
    group = h // kvh
    wgs = fa.segment_warpgroups(d, pipelined)
    heads, tiles, n_blocks = fa.segment_fwd_grid(s_q, h, kvh, d, pipelined)
    assert heads * tiles == wgs and heads == (wgs if group % wgs == 0 else 1)
    blocks = fa.segment_fwd_blocks(s_q, h, kvh, d, pipelined).numpy()
    assert blocks.shape == (n_blocks, wgs, 2)
    n_q_tiles = -(-s_q // fa.TILE)
    owners = np.zeros((h, n_q_tiles * fa.TILE), dtype=np.int64)
    padded_tiles, empty_blocks = set(), set()
    for b, block in enumerate(blocks):
        for head, tile in block:
            rows = max(0, min(fa.TILE, s_q - tile * fa.TILE))
            if rows == 0:  # a warpgroup past the last query tile holds no rows
                empty_blocks.add(b)
                continue
            owners[head, tile * fa.TILE:tile * fa.TILE + rows] += 1
            if rows < fa.TILE:
                padded_tiles.add(int(tile))
        # the warpgroups of a block read the K/V of one KV head
        assert len({int(head) // group for head, _ in block}) == 1
        if heads > 1:  # a GQA group's heads on the same token rows: they share stages, codes and masks
            assert len({int(tile) for _, tile in block}) == 1 and len({int(head) for head, _ in block}) == wgs
        else:  # consecutive query tiles of one head
            assert len({int(head) for head, _ in block}) == 1
            assert list(block[:, 1]) == list(range(block[0, 1], block[0, 1] + wgs))
    assert (owners[:, :s_q] == 1).all()
    # padding lies only in the last query tile, and warpgroups without rows only in a head's last block
    assert padded_tiles <= {n_q_tiles - 1} and (s_q % fa.TILE == 0) == (not padded_tiles)
    per_head = n_blocks // (h // heads)
    assert all(b % per_head == per_head - 1 for b in empty_blocks)


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_query_row_has_one_owner(name):
    _check_owners(name, 80, False)  # the lockstep block of three warpgroups


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("name", list(SHAPES))
def test_every_query_row_has_one_owner_in_each_block(name, block):
    _check_owners(name, *BLOCKS[block])


def test_segment_fwd_grid_at_the_main_path_shapes():
    assert WGS == 3 and fa.WS_WARPGROUPS == 2
    # K2 / K3 at head dim 128, the warp-specialised block: the recon and chat prefills and the training
    # pack, 392, 756 and 200 query tiles, 2 KV heads, their 6 query heads in 3 blocks of 2
    assert fa.segment_fwd_grid(25088, 12, 2, 128) == (2, 1, 392 * 2 * 3)
    assert fa.segment_fwd_grid(48384, 12, 2, 128) == (2, 1, 756 * 2 * 3)
    assert fa.segment_fwd_grid(12800, 12, 2, 128) == (2, 1, 200 * 2 * 3)
    # K4 and K8 there keep the lockstep block: 2 blocks of 3 heads
    assert fa.segment_fwd_grid(25088, 12, 2, 128, pipelined=True) == (3, 1, 392 * 2 * 2)
    assert fa.segment_fwd_grid(48384, 12, 2, 128, int8=True) == (3, 1, 756 * 2 * 2)
    # a ViT chunk (G = 1): 183 query tiles of each of 16 heads in blocks of 3 consecutive tiles
    assert fa.segment_fwd_grid(11664, 16, 16, 80) == (1, 3, 61 * 16)
    # a group of 3 at head dim 128: one head, two query tiles; of 2 below it: one head, three query tiles
    assert fa.segment_fwd_grid(333, 6, 2, 128) == (1, 2, 3 * 6)
    assert fa.segment_fwd_grid(333, 4, 2, 96) == (1, 3, 2 * 4)


def _chat_layout():
    """The sorted [und | geo | padding] chat prefill at tiny_test_config size: two views."""
    pipe = G2VLMPipeline(None, tiny_test_config())
    grid = vit_device_grid((112, 112))
    pre = pipe.build_chat_prefill(2, 3, 5, [grid] * 2, "Which point is closer to the camera?")
    perm = torch.as_tensor(split_order(pre)[0])
    return TokenInfo(*(f[perm] for f in pre.token_info("cpu")))


def _vit_layout():
    """A ViT chunk's layout: each image a segment of full attention (doc = fn = image id), padding after;
    its query tiles straddle two images."""
    seg = torch.cat([torch.arange(3, dtype=torch.int32).repeat_interleave(100),
                     torch.full((20,), -1, dtype=torch.int32)])
    return TokenInfo(seg, seg, torch.full_like(seg, -1), torch.arange(len(seg), dtype=torch.int32))


INFOS = {f"codes_case{i}": (lambda c=c: make_token_info(c["sample_lens"], c["split_lens"], c["modes"],
                                                         pad_to=c.get("pad_to")))
         for i, c in enumerate(CODE_CASES)}
INFOS["sorted_chat_tiny"] = _chat_layout
INFOS["vit_images"] = _vit_layout


HEADS = {"12:2": (12, 2), "6:2": (6, 2), "4:2": (4, 2), "3:3": (3, 3), "16:16": (16, 16)}


def _check_ring(info_name, heads, d):
    info = INFOS[info_name]()
    h, kvh = heads
    meta = info.packed()
    codes = fa.block_codes(meta, meta)
    n_q_tiles, n_kv_tiles = codes.shape
    blocks = fa.segment_fwd_blocks(info.seq_len, h, kvh, d)
    # each warpgroup's code of every K/V tile (SKIP past the last query tile), and the tiles that
    # enter the block's ring: those that some warpgroup's code does not mark SKIP
    per_wg = torch.cat([codes, codes.new_full((1, n_kv_tiles), fa.BLOCK_SKIP)])[blocks[..., 1].clamp(max=n_q_tiles)]
    live = (per_wg != fa.BLOCK_SKIP).any(1)
    visible = make_segment_mask(info, info)
    pad = -info.seq_len % fa.TILE
    visible = torch.nn.functional.pad(visible, (0, pad, 0, pad)).view(n_q_tiles, fa.TILE, n_kv_tiles, fa.TILE)
    tile_visible = torch.cat([visible.any(3).any(1), torch.zeros((1, n_kv_tiles), dtype=torch.bool)])
    heads_share_rows = fa.segment_fwd_grid(info.seq_len, h, kvh, d)[0] == fa.segment_warpgroups(d)
    for b, block in enumerate(blocks):
        # no visible pair of any warpgroup lies in a tile the ring leaves out
        assert not (tile_visible[block[:, 1].clamp(max=n_q_tiles)].any(0) & ~live[b]).any()
        if heads_share_rows:  # one query tile: one code per K/V tile for the whole block, one mask
            assert (per_wg[b] == per_wg[b, 0]).all()


@pytest.mark.parametrize("heads", list(HEADS.values()), ids=list(HEADS))
@pytest.mark.parametrize("info_name", list(INFOS))
def test_a_tile_leaves_the_ring_only_when_every_warpgroup_skips_it(info_name, heads):
    _check_ring(info_name, heads, 80)  # the lockstep block of three warpgroups


@pytest.mark.parametrize("heads", list(HEADS.values()), ids=list(HEADS))
@pytest.mark.parametrize("info_name", list(INFOS))
def test_a_tile_leaves_the_warp_specialised_ring_only_when_both_warpgroups_skip_it(info_name, heads):
    _check_ring(info_name, heads, 128)
