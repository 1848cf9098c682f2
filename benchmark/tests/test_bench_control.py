"""The check fails what it has to fail, at tiny widths on the CPU: the
control (the reference with its products in float8 e4m3 in the system's
place) reads above the cell's limits, the system in bfloat16 below them, and
a run whose timed path is broken underneath (an answer or a token altered
where it is produced) comes out not correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import core


def _state(cell, tiny, seed, n=4):
    c = core.resolve(core.spec(), cell)
    o = tiny(cell)
    mix = dict(c.mix, **o["mix"])
    st = c.driver.setup(o["config"], mix, seed, "cpu")
    for i in range(n):
        inp = c.driver.make_input(st, i)
        out, _ = c.driver.call(st, inp, False)
        c.driver.keep(st, i, inp, out)
    c.driver.release(st)
    return c, st


@pytest.mark.parametrize("cell", ["recon-32v", "chat-short"])
def test_the_control_fails_and_the_system_passes(cell, tiny):
    for seed in (1, 3):
        c, st = _state(cell, tiny, seed)
        system = c.driver.readings(st)
        control = c.driver.readings(st, quant=torch.float8_e4m3fn)
        assert all(v <= c.limits[k] for k, v in system.items()), system
        assert any(v > c.limits[k] for k, v in control.items()), control


def _swap_views(st):
    run = st.pipe.recon_from_frames

    def altered(frames, **kw):  # the first two views' outputs trade places
        return {k: v[[1, 0, *range(2, len(v))]] for k, v in run(frames, **kw).items()}

    st.pipe.recon_from_frames = altered


def _alter_tokens(monkeypatch):
    from g2vlm_tpu_torch.inference import decoding

    step = decoding._decode_step

    def altered(*a, **kw):
        return step(*a, **kw).roll(1, dims=-1)  # every step emits the token after its best

    def fault(st):
        monkeypatch.setattr(decoding, "_decode_step", altered)

    return fault


@pytest.mark.parametrize("cell", ["recon-32v", "chat-short"])
def test_an_altered_answer_is_not_correct(cell, tiny, monkeypatch):
    clean = core.run_cell(cell, 11, 0.5, False, time.perf_counter(), device="cpu", overrides=tiny(cell))
    assert clean["correct"] is True
    assert np.isfinite([v["value"] for v in clean["checks"].values()]).all()
    fault = _swap_views if cell == "recon-32v" else _alter_tokens(monkeypatch)
    out = core.run_cell(cell, 11, 0.5, False, time.perf_counter(), device="cpu", overrides=tiny(cell), fault=fault)
    assert out["correct"] is False and out["attempted"] > 0
    assert any(v["value"] > v["limit"] for v in out["checks"].values())
