"""Multi-view reconstruction on the Kimi-VL decoder's configuration
(configs/g2vlm-kimivl-a3b-bf16.json): the recon driver's traffic, calls and
sampling (drivers/recon.py), with the system built as an "mla_moe" G2VLM, the
work counted by work/kimivl.py, and the check against reference/kimivl.py.

Routing: a trained router's `e_score_correction_bias` keeps the experts' loads
even (DeepSeek-V3's auxiliary-loss-free balancing); the drawn one does not, and on
the seed's random weights a few experts would take most rows of a layer. So set-up
sets each layer's bias as that balancing does, by sign updates, on one more scene
of the traffic's kind drawn from the seed (`balance`), before the warm-up.

Check: as the recon driver's, each output's relative error over the kept
calls against the float32 reference from the same frames and weights (the
balanced biases included), the reference's weights held in bf16 (the drawn
values; each leaf cast to float32 where it is used), so that they fit the card
once the system is released. The reference follows the system's routing at
near ties (reference/kimivl.py `route`): before the system is released, each
kept call runs again with a pre-hook on each MoE layer that takes the top k of
the router's rule on the rows reaching it (`routes`); the control's own choices
are followed likewise.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import weights
from ..reference import kimivl
from ..reference.layout import recon_layout
from ..reference.preprocess import target_hw
from ..traffic import frames as frame_pool
from ..work import kimivl as work_counts
from .recon import DTYPES, OUTPUTS, call, keep, lap, make_input, sync
from .recon import release as release_system

__all__ = ["setup", "make_input", "call", "work", "keep", "release", "readings", "check"]

# the balancing's sign updates a layer, and their step: geometric from the first to the last
BALANCE_STEPS = 200
BALANCE_GAMMA = (0.05, 0.001)


def program_config(c: Dict):
    """The system's G2VLMConfig: the published text config's keys at the top level of the file
    make its MLAMoEConfig; the towers and heads come from their groups."""
    from g2vlm_tpu_torch import config as pc

    def make(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    top = {k: v for k, v in c.items() if not isinstance(v, dict)}
    return make(pc.G2VLMConfig, dict(top, llm=make(pc.MLAMoEConfig, top), vit=make(pc.VitConfig, c["vit"]),
                                     dino=make(pc.DinoConfig, c["dino"]), pi3=make(pc.Pi3HeadConfig, c["pi3"])))


def build(cfg: Dict, seed: int, device: str, parts: Dict[str, float]):
    """The system's model and pipeline with the seed's weights; the seconds of each part go into `parts`."""
    t = time.perf_counter()
    from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
    from g2vlm_tpu_torch.weights import build_model

    pcfg = program_config(cfg)
    t = lap(parts, "system import", t)
    torch.empty(0, device=device)  # the first use of the device makes its context
    sync(device)
    t = lap(parts, "device context", t)
    model = build_model(pcfg, device=device, dtype=DTYPES[cfg["dtype"]], seed=None)
    sync(device)
    t = lap(parts, "build_model", t)
    weights.load_into(model, kimivl.param_shapes(cfg), seed)
    sync(device)
    lap(parts, "weights", t)
    return G2VLMPipeline(model, pcfg)


def balance(pipe, cfg: Dict, frames: np.ndarray, new_width: int, rows: int) -> Dict[str, torch.Tensor]:
    """DeepSeek-V3's auxiliary-loss-free balancing, on one recon call of `frames`: in each MoE
    layer in turn, on the first `rows` rows that reach its router (the sequence's own, not the
    system's padding), `BALANCE_STEPS` sign updates of the bias, b_e += gamma * sign(mean load -
    load_e), from the drawn bias less its mean (and less its mean again after), so that each expert
    is chosen about T * k / E times; the layer then routes with the new bias, and the next layer
    balances on what it gives. Returns the biases by state-dict key (in the model's dtype)."""
    k, out = cfg["num_experts_per_tok"], {}
    gammas = np.geomspace(*BALANCE_GAMMA, BALANCE_STEPS) if BALANCE_STEPS else []

    def hook(name, m, args):
        bias = m.gate.e_score_correction_bias
        scores = _scores(m, args[0][:rows])
        b = bias.float() - bias.float().mean()
        target = scores.shape[0] * k / scores.shape[1]
        ones = torch.ones(scores.shape[0] * k, device=scores.device)
        for g in gammas:
            idx = torch.topk(scores + b, k, dim=-1, sorted=False).indices.reshape(-1)
            load = torch.zeros_like(b).scatter_add_(0, idx, ones)
            b += float(g) * torch.sign(target - load)
        bias.data.copy_(b - b.mean())
        out[name + ".gate.e_score_correction_bias"] = bias.detach().clone()

    _with_routers(pipe, hook, frames, new_width)
    return out


def _scores(m, h: torch.Tensor) -> torch.Tensor:
    """The router's unbiased scores of the rows h, as the published rule makes them."""
    return F.linear(h.float(), m.gate.weight.float()).sigmoid()


def _with_routers(pipe, hook, frames: np.ndarray, new_width: int) -> None:
    """One recon call of `frames` with `hook(name, module, args)` run before each MoE layer."""
    hooks = [m.register_forward_pre_hook(lambda m, args, name=name: hook(name, m, args))
             for name, m in pipe.model.named_modules() if hasattr(getattr(m, "gate", None), "e_score_correction_bias")]
    try:
        pipe.recon_from_frames(frames, new_width=new_width)
    finally:
        for h in hooks:
            h.remove()


def routes(pipe, cfg: Dict, frames: np.ndarray, new_width: int) -> List[torch.Tensor]:
    """The experts that the router's rule chooses, in each MoE layer in turn, for the rows that reach
    the system's router in a recon call of `frames`: (rows, k) int16 each. The call itself runs as
    it does in the window."""
    out = []

    def hook(name, m, args):
        biased = _scores(m, args[0]) + m.gate.e_score_correction_bias.float()[None]
        out.append(torch.topk(biased, cfg["num_experts_per_tok"], -1).indices.to(torch.int16))

    _with_routers(pipe, hook, frames, new_width)
    return out


def setup(cfg: Dict, mix: Dict, seed: int, device: str) -> SimpleNamespace:
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    n, h, w = mix["views"], mix["height"], mix["width"]
    pool = frame_pool.pool(rng, mix["scenes"] * n, h, w).reshape(mix["scenes"], n, h, w, 3)
    p = cfg["dino"]["patch_size"]
    th, tw = target_hw(h, w, mix["new_width"], p)
    st = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device, pool=pool, rng=rng, kept=[],
                         work=work_counts.recon_work(cfg, n, th // p, tw // p), setup_parts={})
    lap(st.setup_parts, "traffic", t)
    st.pipe = build(cfg, seed, device, st.setup_parts)
    t = time.perf_counter()
    scene = frame_pool.pool(np.random.default_rng((seed, 1)), n, h, w)  # apart from the traffic's draws
    st.bias = balance(st.pipe, cfg, scene, mix["new_width"], recon_layout(n, th // p, tw // p).seq_len)
    sync(device)
    t = lap(st.setup_parts, "balance", t)
    for i in range(mix.get("warmup", 1)):
        call(st, make_input(st, i), False)
    sync(device)
    lap(st.setup_parts, "warm-up", t)
    return st


def work(st, frames, out) -> Dict[str, float]:
    return st.work


def release(st) -> None:
    """The system's routing of the kept calls (for the check's near ties), then the recon driver's
    release."""
    st.routes = [routes(st.pipe, st.cfg, make_input(st, i), st.mix["new_width"]) for i, _ in st.kept]
    release_system(st)


def readings(st, quant: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Relative error of each output over the kept calls: the system's, or with `quant` the
    reference's own in that precision (the control)."""
    W = {}
    for part in weights.chunks(kimivl.param_shapes(st.cfg), st.seed, st.device, DTYPES[st.cfg["dtype"]]):
        W.update((k, v) for k, v in part.items() if not k.startswith(("vit_model.", "language_model.lm_head")))
    W.update(st.bias)
    W = kimivl.Fp32(W)
    err = {k: 0.0 for k in OUTPUTS}
    with torch.no_grad():
        for (i, out), chosen in zip(st.kept, st.routes):
            frames = torch.as_tensor(make_input(st, i), device=st.device)
            if quant is not None:
                record = []
                got = kimivl.recon(W, st.cfg, frames, st.mix["new_width"], quant=quant, record=record)
                chosen = [idx for _, idx in record]
                del record
            else:
                got = {k: torch.as_tensor(out[k], device=st.device) for k in OUTPUTS}
            want = kimivl.recon(W, st.cfg, frames, st.mix["new_width"], follow=chosen)
            for k in OUTPUTS:
                e = (torch.linalg.vector_norm(got[k].float() - want[k]) / torch.linalg.vector_norm(want[k])).item()
                err[k] = max(err[k], e if np.isfinite(e) else float("inf"))
            del want, got
    return {f"{k}_rel_err": v for k, v in err.items()}


def check(st, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": limits[k]} for k, v in readings(st).items()}
