"""Checkpoints of the training state (port of g2vlm_tpu/train/checkpoint.py,
which saves through Orbax): the fp32 parameters, the optimizer state (the
first moment, the second moment whole or as its factored rows and columns,
the update count), the EMA and the step, with the data cursors
(`data_status`) as JSON beside them, and the newest `keep` checkpoints kept.

Layout: `<directory>/<step>/state.safetensors` (the port's own safetensors
writer, `weights.save_safetensors`; keys `params/<name>`, `buffers/<name>`
(the SegFormer's BatchNorm statistics, where the model has it), `ema/<name>`,
`mu/<name>`, `nu/<name>` or `nu_row/<name>` and `nu_col/<name>`, and the
0-d int64 `step` and `count`) and `<directory>/data_status_<step>.json`. A
step is written into a temporary directory and renamed, so an interrupted
save leaves no half checkpoint. Saving is synchronous; `wait` is there for
the JAX call sites.

A sharded state (`parallel.mesh.shard_model`) is saved as the whole tensors:
every rank gathers them and rank 0 writes the same file as one process, so
a checkpoint of a sharded run loads in a one-card run and the other way
round; `restore` copies each rank's own slice into its shards.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import comm
from ..weights import load_safetensors, save_safetensors
from .trainer import TrainState

STATE_FILE = "state.safetensors"


def _slot_layout(p: torch.Tensor, kind: str):
    """(placements, global shape) of an optimizer slot of sharded parameter
    `p`: the moments lie like the parameter; the factored row means drop its
    last dim (a split there was summed away), the column means its
    second-to-last."""
    from torch.distributed.tensor import Replicate, Shard

    nd, pl = p.dim(), list(p.placements)
    if kind in ("mu", "nu"):
        return pl, tuple(p.shape)
    if kind == "nu_row":
        return [Replicate() if getattr(x, "dim", None) == nd - 1 else x for x in pl], tuple(p.shape[:-1])
    out = []
    for x in pl:
        d = getattr(x, "dim", None)
        out.append(Replicate() if d == nd - 2 else Shard(nd - 2) if d == nd - 1 else x)
    return out, tuple(p.shape[:-2] + p.shape[-1:])


class _Sharded:
    """A local shard with the layout to gather it whole or to cut it from the
    whole: the DTensor parameter it belongs to (its mesh) and the slot's
    placements and global shape."""

    def __init__(self, local, like, placements, shape):
        self.local, self.like, self.placements, self.shape = local, like, placements, shape

    def full(self) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        stride = torch.empty(self.shape, device="meta").stride()
        return DTensor.from_local(self.local, self.like.device_mesh, self.placements, run_check=False,
                                  shape=torch.Size(self.shape), stride=stride).full_tensor()

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        size, offset = compute_local_shape_and_global_offset(self.shape, self.like.device_mesh, self.placements)
        return whole[tuple(slice(o, o + n) for o, n in zip(offset, size))]


def _entry(t: torch.Tensor, like: torch.Tensor = None, kind: str = "mu"):
    """A state tensor as saved: itself where whole, else its `_Sharded`
    (`like`: the parameter whose slot a local tensor is)."""
    if comm.is_dtensor(t):
        return _Sharded(t.detach().to_local(), t, list(t.placements), tuple(t.shape))
    if like is not None and comm.is_dtensor(like):
        return _Sharded(t, like, *_slot_layout(like, kind))
    return t


def _state_entries(state: TrainState) -> Dict[str, Any]:
    """{key: tensor or `_Sharded`}; the optimizer's slots by parameter name."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"params/{n}": _entry(p.detach()) for n, p in state.model.named_parameters()}
    out.update({f"buffers/{n}": b for n, b in state.model.named_buffers()})
    if state.ema_params is not None:
        out.update({f"ema/{n}": _entry(e) for n, e in state.ema_params.items()})
    for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
        n = names[id(p)]
        out[f"mu/{n}"] = _entry(mu, p, "mu")
        if len(nu) == 1:
            out[f"nu/{n}"] = _entry(nu[0], p, "nu")
        else:
            out[f"nu_row/{n}"], out[f"nu_col/{n}"] = _entry(nu[0], p, "nu_row"), _entry(nu[1], p, "nu_col")
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    out["count"] = torch.tensor(opt.count, dtype=torch.int64)
    return out


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as flat {key: whole tensor}; the optimizer's slots by
    parameter name. A sharded state's tensors are gathered: a collective,
    which every rank must call."""
    return {k: e.full() if isinstance(e, _Sharded) else e for k, e in _state_entries(state).items()}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state: TrainState, data_status: Optional[Dict[str, Any]] = None) -> None:
        """Every rank calls it (a sharded state is gathered); rank 0 writes."""
        tensors = state_tensors(state)
        if _rank() == 0:
            self._write(step, tensors, data_status)
        _barrier()

    def _write(self, step: int, tensors: Dict[str, torch.Tensor], data_status) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        save_safetensors(os.path.join(tmp, STATE_FILE), tensors)
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        status_path = os.path.join(self.directory, f"data_status_{step}.json")
        if data_status is not None:
            with open(status_path, "w") as f:
                json.dump(data_status, f)
        elif os.path.exists(status_path):  # an earlier save of this step's
            os.remove(status_path)
        for old in self._steps()[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))
            status = os.path.join(self.directory, f"data_status_{old}.json")
            if os.path.exists(status):
                os.remove(status)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> Tuple[TrainState, Optional[Dict[str, Any]]]:
        """Copies checkpoint `step` (the newest by default) into `state`'s
        tensors in place and returns (state, data_status or None). Every
        tensor of the state must be in the file with its shape and dtype, and
        the file must hold nothing else."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        saved = load_safetensors(os.path.join(self.directory, str(step), STATE_FILE))
        want = _state_entries(state)
        missing, unknown = sorted(set(want) - set(saved)), sorted(set(saved) - set(want))
        if missing or unknown:
            raise KeyError(f"checkpoint {step} does not fit the state: missing {missing[:5]}, unknown {unknown[:5]}")
        with torch.no_grad():
            for key, e in want.items():
                src = saved[key]
                shape, t = (e.shape, e.local) if isinstance(e, _Sharded) else (tuple(e.shape), e)
                if tuple(src.shape) != shape or src.dtype != t.dtype:
                    raise ValueError(f"checkpoint {step}: {key} is {src.dtype} {tuple(src.shape)}, "
                                     f"the state's {t.dtype} {shape}")
                if key not in ("step", "count"):
                    t.copy_(e.cut(src) if isinstance(e, _Sharded) else src)
        state.step = int(saved["step"])
        state.optimizer.count = int(saved["count"])
        data_status = None
        path = os.path.join(self.directory, f"data_status_{step}.json")
        if os.path.exists(path):
            with open(path) as f:
                data_status = json.load(f)
        return state, data_status
