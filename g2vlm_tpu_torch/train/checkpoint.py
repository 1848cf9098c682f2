"""Checkpoints of the training state (port of g2vlm_tpu/train/checkpoint.py,
which saves through Orbax): the fp32 parameters, the optimizer state (the
first moment, the second moment whole or as its factored rows and columns,
the update count), the EMA and the step, with the data cursors
(`data_status`) as JSON beside them, and the newest `keep` checkpoints kept.

Layout: `<directory>/<step>/state.safetensors` (the port's own safetensors
writer, `weights.save_safetensors`; keys `params/<name>`, `ema/<name>`,
`mu/<name>`, `nu/<name>` or `nu_row/<name>` and `nu_col/<name>`, and the
0-d int64 `step` and `count`) and `<directory>/data_status_<step>.json`. A
step is written into a temporary directory and renamed, so an interrupted
save leaves no half checkpoint. Saving is synchronous; `wait` is there for
the JAX call sites.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

from ..weights import load_safetensors, save_safetensors
from .trainer import TrainState

STATE_FILE = "state.safetensors"


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as flat {key: tensor}; the optimizer's slots by parameter name."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"params/{n}": p.detach() for n, p in state.model.named_parameters()}
    if state.ema_params is not None:
        out.update({f"ema/{n}": e for n, e in state.ema_params.items()})
    for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
        n = names[id(p)]
        out[f"mu/{n}"] = mu
        if len(nu) == 1:
            out[f"nu/{n}"] = nu[0]
        else:
            out[f"nu_row/{n}"], out[f"nu_col/{n}"] = nu
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    out["count"] = torch.tensor(opt.count, dtype=torch.int64)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state: TrainState, data_status: Optional[Dict[str, Any]] = None) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        save_safetensors(os.path.join(tmp, STATE_FILE), state_tensors(state))
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
        want = state_tensors(state)
        missing, unknown = sorted(set(want) - set(saved)), sorted(set(saved) - set(want))
        if missing or unknown:
            raise KeyError(f"checkpoint {step} does not fit the state: missing {missing[:5]}, unknown {unknown[:5]}")
        with torch.no_grad():
            for key, t in want.items():
                src = saved[key]
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(f"checkpoint {step}: {key} is {src.dtype} {tuple(src.shape)}, "
                                     f"the state's {t.dtype} {tuple(t.shape)}")
                if key not in ("step", "count"):
                    t.copy_(src)
        state.step = int(saved["step"])
        state.optimizer.count = int(saved["count"])
        data_status = None
        path = os.path.join(self.directory, f"data_status_{step}.json")
        if os.path.exists(path):
            with open(path) as f:
                data_status = json.load(f)
        return state, data_status
