"""A Linear applied in a compute dtype (the `_lin` of the JAX modules:
`x.astype(dtype) @ w.astype(dtype) + b.astype(dtype)`). Parameters already in
that dtype are used as they are, so a bf16 model pays nothing; fp32 master
weights are cast per use and receive fp32 gradients through the cast. A
weight split over a tensor-parallel mesh (a DTensor, `parallel.mesh`) is
applied on its local shard (`tp_linear`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm


def linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    if comm.is_dtensor(lin.weight):
        return tp_linear(x, lin, dt)
    return F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))


def tp_linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """A Linear whose weight is a DTensor split over the tp sub-mesh, on the
    local shards: column-parallel (weight split on its rows) gives this rank's
    output features, row-parallel (split on its columns) takes this rank's
    input features and sums the partial products over the group."""
    w = lin.weight
    group = w.device_mesh.get_group()
    if w.placements[0].dim == 0:
        b = lin.bias
        return F.linear(comm.copy_to(x, group).to(dt), w.to_local().to(dt),
                        None if b is None else b.to_local().to(dt))
    if lin.bias is not None:
        raise ValueError("a row-parallel projection with a bias is not in the TP plan")
    return comm.reduce_from(F.linear(x.to(dt), w.to_local().to(dt)), group)
