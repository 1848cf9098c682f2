"""Sequence-parallel segment attention (port of
g2vlm_tpu/parallel/sequence.py): the query rows of one packed sequence split
over the ranks of a process group, the (small, GQA) K / V and their metadata
all-gathered, and each rank running the ordinary segment attention, the
port's kernels on the card, on its own query rows against the whole K / V.

The mask reads per-token metadata (doc / fn / noise / pos), so a contiguous
split of the pack keeps exactly the attention pattern of the whole; the
kernels take S_q != S_kv (a query shard of S / n rows against S keys).

Every rank of the group holds the same activations (the ranks of one dp group
compute one pack, as the JAX mesh's do): `sequence_parallel_attention` takes
the global q, k, v, slices this rank's rows and all-gathers the result. The
gradients are those of one copy of the loss on every rank: the K / V gather's
backward is a reduce-scatter (sum) of the ranks' parts of dK / dV, the slices'
backward an all-gather (`parallel/comm.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import segment_attention
from ..ops.masks import TokenInfo
from . import comm


def sp_segment_attention(
    q: torch.Tensor,  # (S_q/n, H, D) this rank's query rows
    k: torch.Tensor,  # (S_kv/n, KVH, D) this rank's K / V rows
    v: torch.Tensor,
    q_info: TokenInfo,  # fields (S_q/n,)
    kv_info: TokenInfo,  # fields (S_kv/n,)
    group,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The per-rank body: all-gather K, V and the K / V metadata over `group`
    (tiled on axis 0, in rank order), then segment attention of the local
    query rows against them."""
    kg, vg = comm.gather_rs(k, group), comm.gather_rs(v, group)
    ig = TokenInfo(*(comm.gather_values(f, group) for f in kv_info))
    return segment_attention(q, kg, vg, q_info, ig, scale=scale, impl=impl)


def sequence_parallel_attention(
    q: torch.Tensor,  # (S_q, H, D) global, the same on every rank of the group
    k: torch.Tensor,  # (S_kv, KVH, D)
    v: torch.Tensor,
    q_info: TokenInfo,
    kv_info: TokenInfo,
    group,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Slices this rank's contiguous rows of q, k, v and their metadata, runs
    `sp_segment_attention`, and all-gathers the global result (S_q, H, D).
    The sequence lengths must divide the group's size."""
    n = comm.group_size(group)
    assert q.shape[0] % n == 0 and k.shape[0] % n == 0, (
        f"sequence lengths {q.shape[0]}/{k.shape[0]} must divide the group's {n} ranks")
    qi = TokenInfo(*(comm.split(f, group) for f in q_info))
    ki = TokenInfo(*(comm.split(f, group) for f in kv_info))
    out = sp_segment_attention(comm.split(q, group), comm.split(k, group), comm.split(v, group), qi, ki, group,
                               scale=scale, impl=impl)
    return comm.gather(out, group)


def sp_attender(info: TokenInfo, group, impl: str = "auto"):
    """attend(q, k, v) for the layers of one forward over one packed
    sequence, sequence-parallel over `group`. Every rank already holds the
    whole K / V and metadata, so nothing is gathered for them: each rank
    attends its own query rows to the whole K / V, `copy_to` sums the ranks'
    parts of dK / dV in the backward, and the output is all-gathered. The
    kernels' plan is made here, once. None when the length does not divide
    the group (the caller falls back to ordinary attention, as the JAX
    dispatch does)."""
    from ..ops import flash_attention as fa

    n = comm.group_size(group)
    if info.seq_len % n:
        return None
    local = TokenInfo(*(comm.split(f, group) for f in info))
    plan = fa.segment_plan(local, info)

    def attend(q, k, v):
        kg, vg = comm.copy_to(k, group), comm.copy_to(v, group)
        out = segment_attention(comm.split(q, group), kg, vg, local, info, impl=impl, plan=plan)
        return comm.gather(out, group)

    return attend
