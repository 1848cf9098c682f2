"""Random weights drawn from the seed, on the device, in the type they are
served in: one `torch.Generator` on the device, one normal draw per chunk of
about 2^29 values, cut into the leaves in the order of their names. The same
seed, device and type give the same values, so the reference draws them
again after the window instead of reading the system's copy.

Scales (the benchmark's own choice; no checkpoint is in the repository):
biases N(0, 0.02^2); every other one-dimensional leaf (norm gains,
LayerScales) 1 + N(0, 0.05^2); token and position embeddings N(0, 0.02^2);
every other leaf N(0, 1 / fan_in), fan_in being its size over its first axis.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Tuple

import torch

CHUNK = 1 << 29


def _kind(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, scale) of the leaf's normal draw."""
    if name.endswith(".bias"):
        return 0.0, 0.02
    if len(shape) == 1:
        return 1.0, 0.05
    if "embed_tokens" in name or "position_embeddings" in name:
        return 0.0, 0.02
    return 0.0, math.prod(shape[1:]) ** -0.5


def chunks(shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype: torch.dtype
           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield {name: tensor} for consecutive groups of leaves, each group one draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    names = sorted(shapes)
    i = 0
    while i < len(names):
        group, total = [], 0
        while i < len(names) and (not group or total + math.prod(shapes[names[i]]) <= CHUNK):
            group.append(names[i])
            total += math.prod(shapes[names[i]])
            i += 1
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        out, off = {}, 0
        for name in group:
            n = math.prod(shapes[name])
            offset, scale = _kind(name, shapes[name])
            t = buf[off:off + n].view(shapes[name]).mul_(scale)
            out[name] = t.add_(offset) if offset else t
            off += n
        yield out
        del buf, out


def load_into(model: torch.nn.Module, shapes: Dict[str, Tuple[int, ...]], seed: int) -> None:
    """Fill the system's model through `load_state_dict`, chunk by chunk; every
    leaf of the model is drawn exactly once."""
    p = next(model.parameters())
    want = set(model.state_dict())
    if want != set(shapes):
        raise ValueError(f"the model's leaves differ from the configuration's: {sorted(want ^ set(shapes))[:8]}")
    for part in chunks(shapes, seed, p.device, p.dtype):
        missing, unexpected = model.load_state_dict(part, strict=False)
        if unexpected:
            raise ValueError(f"unexpected leaves {unexpected[:8]}")


def reference_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype: torch.dtype,
                      keep: Callable[[str], bool] = lambda name: True) -> Dict[str, torch.Tensor]:
    """The same values, as float32, for the leaves that `keep` names."""
    W = {}
    for part in chunks(shapes, seed, device, dtype):
        W.update({k: v.float() for k, v in part.items() if keep(k)})
    return W
