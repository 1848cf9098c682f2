"""The traffic is drawn from the seed: the same seed gives the same requests,
another seed other ones; request sizes are uniform, independent of one
another, and stratified by view count and answer length in every block."""

import numpy as np
import pytest

from benchmark.traffic import frames, requests
from benchmark.tests.conftest import TINY_MIX


def test_frame_pool_is_the_seeds():
    a = frames.pool(np.random.default_rng(3000000001), 3, 30, 50)
    b = frames.pool(np.random.default_rng(3000000001), 3, 30, 50)
    c = frames.pool(np.random.default_rng(3000000002), 3, 30, 50)
    assert a.shape == (3, 30, 50, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])


@pytest.mark.parametrize("mix", ["chat_1to4x480x640"])
def test_sizes_are_the_seeds_uniform_independent_and_stratified(mix):
    m = requests.load_mix(mix)
    lo, hi = m["max_new_tokens"]
    key = lambda b: [(r["views"], r["max_new_tokens"], r["words"]) for r in b]  # noqa: E731
    a = requests.sizes(m, np.random.default_rng([5, 0]))
    assert key(a) == key(requests.sizes(m, np.random.default_rng([5, 0])))
    assert key(a) != key(requests.sizes(m, np.random.default_rng([6, 0])))
    assert key(a) != key(requests.sizes(m, np.random.default_rng([5, 1])))
    blocks = [requests.sizes(m, np.random.default_rng([s, b])) for s in (1, 3000000003) for b in range(400)]
    width = (hi - lo + 1) / m["bands"]
    for b in blocks:  # each block: every view count with every band of answer lengths, once
        assert len(b) == 16
        assert sorted(r["views"] for r in b) == sorted(list(range(1, 5)) * m["bands"])
        for v in range(1, 5):
            mine = sorted(r["max_new_tokens"] for r in b if r["views"] == v)
            assert all(lo + int(k * width) <= t <= lo + int((k + 1) * width) for k, t in enumerate(mine))
    rows = np.array([key([r])[0] for b in blocks for r in b], dtype=float)
    views, tokens, n_words = rows.T
    assert tokens.min() == lo and tokens.max() == hi and n_words.min() == 24 and n_words.max() == 64
    for col, (a_, b_) in ((tokens, (lo, hi)), (n_words, tuple(m["question_words"]))):  # uniform
        counts = np.bincount(col.astype(int) - a_, minlength=b_ - a_ + 1)
        assert counts.min() > 0.7 * counts.mean() and counts.max() < 1.3 * counts.mean()
    for x, y in ((views, tokens), (views, n_words), (tokens, n_words)):  # independent of one another
        assert abs(np.corrcoef(x, y)[0, 1]) < 0.03


def _chat_state(seed):
    from types import SimpleNamespace

    from benchmark.drivers import chat

    mix = dict(requests.load_mix("chat_1to4x480x640"), **TINY_MIX["chat-short"])
    st = SimpleNamespace(mix=mix, seed=seed, blocks={}, vocab=requests.words(),
                         pool=frames.pool(np.random.default_rng(seed), mix["pool_frames"], 48, 64))
    return [chat.make_input(st, i) for i in range(9)]


def test_chat_requests_are_the_seeds():
    a, b, c = _chat_state(5), _chat_state(5), _chat_state(6)
    key = [(r["question"], r["max_new_tokens"], tuple(r["idx"])) for r in a]
    assert key == [(r["question"], r["max_new_tokens"], tuple(r["idx"])) for r in b]
    assert key != [(r["question"], r["max_new_tokens"], tuple(r["idx"])) for r in c]
    assert all(np.array_equal(x, y) for r, s in zip(a, b) for x, y in zip(r["frames"], s["frames"]))
    assert all(len(set(r["idx"])) == len(r["idx"]) for r in a)  # distinct frames in a request


def test_recon_calls_cycle_through_distinct_scenes():
    from types import SimpleNamespace

    from benchmark.drivers import recon

    pool = frames.pool(np.random.default_rng(9), 4 * 32, 28, 56).reshape(4, 32, 28, 56, 3)
    st = SimpleNamespace(pool=pool)
    calls = [recon.make_input(st, i) for i in range(8)]
    assert all(c.shape == (32, 28, 56, 3) for c in calls)
    assert np.array_equal(calls[0], calls[4]) and not np.array_equal(calls[0], calls[1])
    assert len({c.tobytes() for c in calls[0]}) == 32
