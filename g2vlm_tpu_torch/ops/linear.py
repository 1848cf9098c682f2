"""A Linear applied in a compute dtype (the `_lin` of the JAX modules:
`x.astype(dtype) @ w.astype(dtype) + b.astype(dtype)`). Parameters already in
that dtype are used as they are, so a bf16 model pays nothing; fp32 master
weights are cast per use and receive fp32 gradients through the cast."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))
