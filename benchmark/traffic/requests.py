"""The request mixes, read from `traffic/mixes/<name>.json`. Sizes come in
blocks drawn from the seed: block b holds one request of every stratum of the
mix (a view count crossed with a band of answer lengths), so that the view
counts and the answer lengths of any run of whole blocks are spread alike
whatever the seed, while each size is drawn uniformly and independently."""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> Dict:
    with open(os.path.join(HERE, "mixes", name + ".json")) as f:
        return json.load(f)


def words() -> List[str]:
    with open(os.path.join(HERE, "words.txt")) as f:
        return f.read().split()


def _uniform_in_band(lo: int, hi: int, band: int, bands: int, u: float) -> int:
    """The integer of [lo, hi] at place `u` (in [0, 1)) of band `band` of
    `bands` equal shares of the range: with `u` uniform and the band uniform,
    the integer is uniform over [lo, hi]."""
    return lo + int((band + u) / bands * (hi - lo + 1))


def sizes(mix: Dict, rng: np.random.Generator) -> List[Dict[str, int]]:
    """One block of request sizes, all from `rng` (the seed's and the block's):
    every view count of the mix crossed with every band of `max_new_tokens`,
    once each, in an order drawn from `rng`; each request's `max_new_tokens`
    uniform within its band and its question length uniform over the whole
    range, drawn apart. So the view count, the answer length and the question
    length are uniform and independent of one another, and a block holds every
    view count with every band of answer lengths."""
    views = list(range(mix["views"][0], mix["views"][1] + 1))
    bands = mix.get("bands", 4)
    cells = list(itertools.product(views, range(bands)))
    u = rng.random(len(cells))
    n_words = rng.integers(mix["question_words"][0], mix["question_words"][1] + 1, size=len(cells))
    out = [{"views": v, "max_new_tokens": _uniform_in_band(*mix["max_new_tokens"], b, bands, float(u[i])),
            "words": int(n_words[i])} for i, (v, b) in enumerate(cells)]
    return [out[i] for i in rng.permutation(len(out))][:mix["block"]]


def question(rng: np.random.Generator, vocab: List[str], n: int) -> str:
    return " ".join(vocab[i] for i in rng.integers(0, len(vocab), size=n))
