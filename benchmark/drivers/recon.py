"""Multi-view reconstruction in a closed loop with one client: each call hands
`G2VLMPipeline.recon_from_frames` the `views` uint8 frames of one scene of a
seeded pool and copies its four outputs to host memory, as a user's script
takes them.

Check: a sample of the calls completed in the window, drawn from the seed as
the window runs (reservoir sampling), is run again through the float32
reference from the same frames and weights. Each output (points,
local_points, global_points, camera_poses) is compared by its relative error,
||system - reference|| / ||reference||, the largest over the sample.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from .. import weights
from ..reference import forward, model as ref_model
from ..reference.preprocess import target_hw
from ..traffic import frames as frame_pool
from ..work import counts

OUTPUTS = ("points", "local_points", "global_points", "camera_poses")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cfg: Dict, seed: int, device: str, parts: Dict[str, float]):
    """The system's model and pipeline with the seed's weights; the seconds
    of each part go into `parts`."""
    t = time.perf_counter()
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.weights import build_model

    from ..core import program_config

    pcfg = program_config(cfg)
    t = lap(parts, "system import", t)
    torch.empty(0, device=device)  # the first use of the device makes its context
    sync(device)
    t = lap(parts, "device context", t)
    model = build_model(pcfg, device=device, dtype=DTYPES[cfg["dtype"]], seed=None)
    sync(device)
    t = lap(parts, "build_model", t)
    weights.load_into(model, ref_model.param_shapes(cfg), seed)
    sync(device)
    lap(parts, "weights", t)
    return G2VLMPipeline(model, pcfg)


def lap(parts: Dict[str, float], name: str, t0: float) -> float:
    """Record the seconds since `t0` under `name`; returns the time now."""
    now = time.perf_counter()
    parts[name] = now - t0
    return now


def setup(cfg: Dict, mix: Dict, seed: int, device: str) -> SimpleNamespace:
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    n, h, w = mix["views"], mix["height"], mix["width"]
    pool = frame_pool.pool(rng, mix["scenes"] * n, h, w).reshape(mix["scenes"], n, h, w, 3)
    p = cfg["dino"]["patch_size"]
    th, tw = target_hw(h, w, mix["new_width"], p)
    st = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device, pool=pool, rng=rng, kept=[],
                         work=counts.recon_work(cfg, n, th // p, tw // p), setup_parts={})
    lap(st.setup_parts, "traffic", t)
    st.pipe = build(cfg, seed, device, st.setup_parts)
    t = time.perf_counter()
    for i in range(mix.get("warmup", 1)):
        call(st, make_input(st, i), False)
    sync(device)
    lap(st.setup_parts, "warm-up", t)
    return st


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def make_input(st, i: int) -> np.ndarray:
    return st.pool[i % len(st.pool)]


def call(st, frames: np.ndarray, trace: bool):
    out = st.pipe.recon_from_frames(frames, new_width=st.mix["new_width"])
    return {k: out[k].float().cpu().numpy() for k in OUTPUTS}, None


def work(st, frames, out) -> Dict[str, float]:
    return st.work


def keep(st, i: int, frames, out) -> None:
    """Reservoir sampling of `check_calls` calls, uniform over the calls completed."""
    k = st.mix["check_calls"]
    if len(st.kept) < k:
        st.kept.append((i, out))
    else:
        j = int(st.rng.integers(0, i + 1))
        if j < k:
            st.kept[j] = (i, out)


def release(st) -> None:
    """Free the system's model and its cached blocks before the reference runs."""
    st.pipe = None
    if st.device == "cuda":
        torch.cuda.empty_cache()


def readings(st, quant: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Relative error of each output over the kept calls: the system's, or
    with `quant` the reference's own in that precision (the control)."""
    W = weights.reference_weights(ref_model.param_shapes(st.cfg), st.seed, st.device, DTYPES[st.cfg["dtype"]],
                                  keep=lambda k: not k.startswith(("vit_model.", "language_model.lm_head")))
    err = {k: 0.0 for k in OUTPUTS}
    with torch.no_grad():
        for i, out in st.kept:
            frames = torch.as_tensor(make_input(st, i), device=st.device)
            want = forward.recon(W, st.cfg, frames, st.mix["new_width"])
            got = (forward.recon(W, st.cfg, frames, st.mix["new_width"], quant=quant) if quant is not None
                   else {k: torch.as_tensor(out[k], device=st.device) for k in OUTPUTS})
            for k in OUTPUTS:
                e = (torch.linalg.vector_norm(got[k].float() - want[k]) / torch.linalg.vector_norm(want[k])).item()
                err[k] = max(err[k], e if np.isfinite(e) else float("inf"))
            del want, got
    return {f"{k}_rel_err": v for k, v in err.items()}


def check(st, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": limits[k]} for k, v in readings(st).items()}
