"""Multi-view chat in a closed loop with one client: each request hands
`G2VLMPipeline.chat` (the default host-preprocess path) distinct uint8 frames
of a seeded pool, a question of random words and a greedy `max_new_tokens`,
sizes drawn in blocks (traffic/requests.py). The pipeline runs without
vocabulary files, so the answer string is the served token ids joined by
spaces, and a request that stopped before `max_new_tokens` emitted the end
token last.

Check: once the window has closed, a sample of the completed requests, drawn
from the seed with the longest among them, is run through the float32
reference over its prompt and served tokens. The number compared is the
widest gap by which a served token's logit lies below the reference's best
at that position.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import weights
from ..reference import forward, layout, model as ref_model
from ..reference.preprocess import target_hw
from ..traffic import frames as frame_pool
from ..traffic import requests
from ..work import counts
from .recon import DTYPES, build, lap, sync


def setup(cfg: Dict, mix: Dict, seed: int, device: str) -> SimpleNamespace:
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    p = cfg["dino"]["patch_size"]
    th, tw = target_hw(mix["height"], mix["width"], 518, p)
    st = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device, kept=[], blocks={}, work={},
                         vocab=requests.words(), grid=(th // p, tw // p), setup_parts={},
                         pool=frame_pool.pool(rng, mix["pool_frames"], mix["height"], mix["width"]))
    lap(st.setup_parts, "traffic", t)
    st.pipe = build(cfg, seed, device, st.setup_parts)
    t = time.perf_counter()
    # one request at each view count, at the longest answer the mix sends
    for v in range(mix["views"][0], mix["views"][1] + 1):
        inp = _request(st, np.random.default_rng([seed, 1 << 40, v]),
                       {"views": v, "words": mix["question_words"][1], "max_new_tokens": mix["max_new_tokens"][1]})
        call(st, inp, False)
    sync(device)
    lap(st.setup_parts, "warm-up", t)
    return st


def _request(st, rng: np.random.Generator, size: Dict[str, int]) -> Dict:
    idx = rng.choice(len(st.pool), size=size["views"], replace=False)
    return {"frames": [st.pool[j] for j in idx], "idx": idx, "question": requests.question(rng, st.vocab, size["words"]),
            "words": size["words"], "max_new_tokens": size["max_new_tokens"]}


def make_input(st, i: int) -> Dict:
    b, k = divmod(i, st.mix["block"])
    if b not in st.blocks:
        st.blocks = {b: requests.sizes(st.mix, np.random.default_rng([st.seed, b]))}
    return _request(st, np.random.default_rng([st.seed, b, k]), st.blocks[b][k])


def call(st, inp: Dict, trace: bool):
    res = st.pipe.chat(inp["frames"], inp["question"], max_new_tokens=inp["max_new_tokens"], return_info=trace)
    text, info = res if trace else (res, None)
    served = [int(t) for t in text.split()]
    if len(served) < inp["max_new_tokens"]:
        served.append(layout.EOS)
    return served, info


def work(st, inp, served) -> Dict[str, float]:
    key = (len(inp["frames"]), inp["words"], len(served))
    if key not in st.work:
        st.work[key] = counts.chat_work(st.cfg, key[0], *st.grid, key[1], key[2])
    return st.work[key]


def keep(st, i: int, inp, served) -> None:
    st.kept.append((i, inp, served))


def release(st) -> None:
    st.pipe = None
    if st.device == "cuda":
        torch.cuda.empty_cache()


def sample(st) -> List:
    """The request that served the most tokens, then others drawn from the
    seed until `check_tokens` served tokens or `check_requests` requests."""
    kept = st.kept
    if not kept:
        return []
    first = max(range(len(kept)), key=lambda j: (len(kept[j][2]), len(kept[j][1]["frames"])))
    rest = [j for j in np.random.default_rng([st.seed, 7]).permutation(len(kept)) if j != first]
    out, n = [kept[first]], len(kept[first][2])
    for j in rest:
        if n >= st.mix["check_tokens"] or len(out) >= st.mix["check_requests"]:
            break
        out.append(kept[j])
        n += len(kept[j][2])
    return out


def readings(st, quant: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The widest gap of a served token's reference logit below the
    reference's best; with `quant` the gap of the token that the reference
    in that precision puts first (the control)."""
    W = weights.reference_weights(ref_model.param_shapes(st.cfg), st.seed, st.device, DTYPES[st.cfg["dtype"]],
                                  keep=lambda k: not k.startswith(("point_", "camera_", "global_point")))
    gap = 0.0
    with torch.no_grad():
        for _, inp, served in sample(st):
            want = forward.chat_logits(W, st.cfg, inp["frames"], inp["question"], served, st.device)
            if quant is None:
                chosen = torch.as_tensor(served, device=st.device)
            else:
                chosen = forward.chat_logits(W, st.cfg, inp["frames"], inp["question"], served, st.device,
                                             quant=quant).argmax(-1)
            g = (want.max(-1).values - want.gather(1, chosen[:, None])[:, 0]).max().item()
            gap = max(gap, g if np.isfinite(g) else float("inf"))
    return {"logit_gap": gap}


def check(st, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": limits[k]} for k, v in readings(st).items()}
