"""The port's span recorder (g2vlm_tpu_torch/utils/tracing.py) on the CPU: off
it hands out one shared no-op; inside `record()` spans nest under one request
with self times and counters, in a bounded buffer; under torch.profiler they
land in the chrome trace as user_annotation ranges; the recon and chat calls
of `G2VLMPipeline` at tiny widths record the spans of their stages; and the
benchmark's readers of them read the requests they should."""

import dataclasses
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from g2vlm_tpu_torch.config import tiny_test_config
from g2vlm_tpu_torch.inference.pipeline import G2VLMPipeline
from g2vlm_tpu_torch.utils import tracing
from g2vlm_tpu_torch.weights import build_model

_TINY = tiny_test_config()
# vocab wide enough for the pipeline's crc32 prompt ids (< 5,100)
CFG = dataclasses.replace(_TINY, llm=dataclasses.replace(_TINY.llm, vocab_size=5120))
TOKEN_IDS = dict(bos_token_id=7, eos_token_id=8, start_of_image=11, end_of_image=12)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    return G2VLMPipeline(build_model(CFG, device="cpu", seed=0), CFG, new_token_ids=dict(TOKEN_IDS),
                         seq_pad_multiple=32)


def _tree(span):
    return (span.name, [_tree(c) for c in span.children])


def test_off_hands_out_the_shared_no_op_and_records_nothing():
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b is tracing.OFF
    with a as s:
        tracing.count("n", 5)
    assert s.host_s is None and s.device_ms is None
    assert tracing.requests() == [] and tracing.summary() == {"requests": {}, "spans": {}, "counters": {}}


def test_spans_nest_under_one_request_with_self_times_and_counters():
    with tracing.record():
        assert tracing.span("probe") is not tracing.OFF
        for _ in range(2):
            with tracing.span("top") as top:
                with tracing.span("a") as a:
                    with tracing.span("a.1") as a1:
                        tracing.count("bytes", 3)
                with tracing.span("b") as b:
                    tracing.count("bytes", 4)
        with tracing.span("other"):
            pass
        tracing.count("dropped", 1)  # no span open: no request to add to
    assert tracing.span("probe") is tracing.OFF
    reqs = tracing.requests()
    assert [_tree(r) for r in reqs] == [("top", [("a", [("a.1", [])]), ("b", [])])] * 2 + [("other", [])]
    assert a1.parent is a and a.parent is top and top.parent is None
    assert {s.rid for s in top.walk()} == {top.rid} and reqs[0].rid != reqs[1].rid != reqs[2].rid
    assert top.counters == {"bytes": 7} and a.counters == {} and reqs[2].counters == {}
    assert top.host_s >= a.host_s + b.host_s >= a.host_s >= a1.host_s > 0
    assert top.device_ms is None  # no CUDA here

    s = tracing.summary()
    assert s["requests"] == {"top": 2, "other": 1}
    assert s["counters"] == {("top", "bytes"): 7.0}
    assert set(s["spans"]) == {("top", "top"), ("top", "a"), ("top", "a.1"), ("top", "b"), ("other", "other")}
    want_top = sum(r.host_s for r in reqs[:2]) / 2 * 1e3
    want_self = sum(r.host_s - r.children[0].host_s - r.children[1].host_s for r in reqs[:2]) / 2 * 1e3
    assert s["spans"][("top", "top")]["count"] == 2
    assert s["spans"][("top", "top")]["host_ms"] == pytest.approx(want_top, rel=1e-9)
    assert s["spans"][("top", "top")]["self_host_ms"] == pytest.approx(want_self, rel=1e-9)
    leaf = s["spans"][("top", "a.1")]
    assert leaf["self_host_ms"] == pytest.approx(leaf["host_ms"], rel=1e-9)
    assert leaf["device_ms"] is None and leaf["self_device_ms"] is None


def test_the_buffer_keeps_the_last_requests():
    rec = tracing.Recorder(keep=3)
    with rec.record():
        for i in range(5):
            with rec.span(f"r{i}"):
                rec.count("i", i)
    assert [r.name for r in rec.requests()] == ["r2", "r3", "r4"]
    assert rec.summary()["counters"] == {("r2", "i"): 2.0, ("r3", "i"): 3.0, ("r4", "i"): 4.0}
    assert tracing.requests() == []  # another recorder's buffer


def test_a_profiler_run_records_the_spans_as_user_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(8).sum()
            tracing.count("k", 2)
    assert tracing.span("after") is tracing.OFF
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= set(ann)
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    [r] = tracing.requests()
    assert _tree(r) == ("outer", [("inner", [])]) and r.counters == {"k": 2}
    assert tracing.summary()["requests"] == {"outer": 1}


def test_recon_from_frames_records_its_stages(pipe):
    frames = np.random.default_rng(0).integers(0, 256, (2, 28, 56, 3), dtype=np.uint8)
    want = pipe.recon_from_frames(frames, new_width=56)
    assert tracing.requests() == []
    with tracing.record():
        got = pipe.recon_from_frames(frames, new_width=56)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    [r] = tracing.requests()
    assert _tree(r) == ("recon", [("input", []), ("dino", []), ("decoder", []), ("heads", [])])
    assert r.counters == {"upload.bytes": frames.nbytes}
    s = tracing.summary()["spans"]
    assert all(s[("recon", k)]["device_ms"] is None for k in ("input", "dino", "decoder", "heads"))


def test_recon_from_views_records_its_stages(pipe):
    views = np.random.default_rng(1).random((2, 3, 28, 56)).astype(np.float32)
    with tracing.record():
        pipe.recon_from_views(views)
    [r] = tracing.requests()
    assert _tree(r) == ("recon", [("input", []), ("dino", []), ("decoder", []), ("heads", [])])
    assert r.counters == {"upload.bytes": views.size * 4}


def _frames(n, seed=0):
    return [np.random.default_rng(seed + i).integers(0, 256, (54, 76, 3), dtype=np.uint8) for i in range(n)]


def test_chat_with_return_info_records_its_stages(pipe):
    frames = _frames(2)
    plain = pipe.chat(frames, "which point is closer?", max_new_tokens=5, new_width=56)
    assert tracing.requests() == []
    text, info = pipe.chat(frames, "which point is closer?", max_new_tokens=5, new_width=56, return_info=True)
    assert text == plain
    [r] = tracing.requests()
    assert _tree(r) == ("chat", [
        ("host_images", []), ("upload", []), ("prefill", [("dino", []), ("vit", []), ("decoder", [])]),
        ("cache", []), ("decode", [("decode.first", [])])])
    by_name = {s.name: s for s in r.walk()}
    for key, name in (("t_upload_s", "upload"), ("t_forward_s", "prefill"), ("t_cache_s", "cache"),
                      ("t_decode_s", "decode")):
        assert info[key] == by_name[name].host_s > 0
    assert info["t_prefill_s"] == info["t_upload_s"] + info["t_forward_s"] + info["t_cache_s"]
    # the uint8 frames as they are: the resample runs on the model's device (the plain version here)
    assert r.counters["upload.bytes"] == sum(f.nbytes for f in frames)
    assert r.counters["images.frames"] == 2 and "images.card_frames" not in r.counters
    assert info["request_id"] == r.rid
    s = tracing.summary()
    # the decode loop counts its 5 steps, none of them on the fused kernels on the CPU
    assert r.counters["decode.steps"] == 5 and "decode.fused_steps" not in r.counters
    assert s["requests"] == {"chat": 1} and s["counters"] == {("chat", "upload.bytes"): r.counters["upload.bytes"],
                                                              ("chat", "images.frames"): 2.0,
                                                              ("chat", "decode.steps"): 5.0}
    assert tracing.summary([r.rid]) == s and tracing.summary([r.rid + 1])["requests"] == {}
    assert s["spans"][("chat", "decode.first")]["host_ms"] == pytest.approx(by_name["decode.first"].host_s * 1e3)
    assert all(v["device_ms"] is None for v in s["spans"].values())


def test_chat_device_preprocess_records_the_towers_under_upload(pipe):
    frames = _frames(2, seed=5)
    _, info = pipe.chat(frames, "what is here?", max_new_tokens=4, new_width=56, device_preprocess=True,
                        return_info=True)
    [r] = tracing.requests()
    assert _tree(r) == ("chat", [
        ("upload", [("dino", []), ("vit", [])]), ("prefill", [("decoder", [])]),
        ("cache", []), ("decode", [("decode.first", [])])])
    assert r.counters == {"upload.bytes": 2 * 54 * 76 * 3, "decode.steps": 4}
    assert info["t_upload_s"] == r.children[0].host_s


def test_chat_prefill_times_only_when_asked(pipe):
    frames = _frames(1, seed=9)
    *_, times = pipe.chat_prefill(frames, "why?", new_width=56)
    assert times == (None, None) and tracing.requests() == []
    *_, (t_upload, t_forward) = pipe.chat_prefill(frames, "why?", new_width=56, timed=True)
    reqs = tracing.requests()
    assert [r.name for r in reqs] == ["host_images", "upload", "prefill"]
    assert (t_upload, t_forward) == (reqs[1].host_s, reqs[2].host_s)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", os.path.join(ROOT, "benchmark", "layer_metrics",
                                                                                 name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_benchmark_readers_read_the_requests_outside_the_profiled_window(pipe):
    """The chat readers read the requests of `ctx.samples` by their request id;
    the device readers read None on the CPU."""
    infos = [pipe.chat(_frames(n, seed=20 + n), "how far?", max_new_tokens=3, new_width=56, return_info=True)[1]
             for n in (1, 2)]
    reqs = {r.rid: r for r in tracing.requests()}
    ctx = SimpleNamespace(samples=[{"info": infos[1]}])  # the first request falls in the profiled sub-window
    one = reqs[infos[1]["request_id"]]
    by_name = {x.name: x for x in one.walk()}
    assert _reader("chat.host_images_ms")(ctx) == pytest.approx(by_name["host_images"].host_s * 1e3, rel=1e-9)
    assert _reader("chat.decode_first_ms")(ctx) == pytest.approx(by_name["decode.first"].host_s * 1e3, rel=1e-9)
    assert _reader("chat.upload_mb")(ctx) == one.counters["upload.bytes"] / 1e6
    assert _reader("chat.upload_mb")(SimpleNamespace(samples=[{"info": i} for i in infos])) == pytest.approx(
        sum(reqs[i["request_id"]].counters["upload.bytes"] for i in infos) / 2e6)
    for name in ("chat.vit_ms", "chat.decoder_prefill_ms"):
        assert _reader(name)(ctx) is None
    with tracing.record():
        pipe.recon_from_frames(np.zeros((2, 28, 56, 3), np.uint8), new_width=56)
    for name in ("recon.input_ms", "recon.dino_ms", "recon.decoder_ms", "recon.heads_ms"):
        assert _reader(name)(ctx) is None


def test_the_fused_share_reader_reads_the_decode_loops_counters(pipe):
    """chat.decode_fused_share: 100 x decode.fused_steps / decode.steps over the requests of
    `ctx.samples`; 0 on the CPU, whose loop runs the chain; None without the step counter (a
    program that does not count its steps)."""
    read = _reader("chat.decode_fused_share")
    info = pipe.chat(_frames(1, seed=31), "how near?", max_new_tokens=3, new_width=56, return_info=True)[1]
    ctx = SimpleNamespace(samples=[{"info": info}])
    [r] = tracing.requests()
    assert r.counters["decode.steps"] == 3 and read(ctx) == 0.0
    r.counters["decode.fused_steps"] = 3  # as the loop counts on a bf16 cache on the card
    assert read(ctx) == 100.0
    del r.counters["decode.steps"], r.counters["decode.fused_steps"]
    assert read(ctx) is None


def test_the_images_card_share_reader_reads_the_frame_counters(pipe):
    """chat.images_card_share: 100 x images.card_frames / images.frames over the requests of
    `ctx.samples`; 0 on the CPU, where the plain resample runs; None without the frame counter
    (a program that resizes the images on the host)."""
    read = _reader("chat.images_card_share")
    info = pipe.chat(_frames(2, seed=33), "how wide?", max_new_tokens=2, new_width=56, return_info=True)[1]
    ctx = SimpleNamespace(samples=[{"info": info}])
    [r] = tracing.requests()
    assert r.counters["images.frames"] == 2 and read(ctx) == 0.0
    r.counters["images.card_frames"] = 2  # as the pipeline counts frames resized by the kernels on the card
    assert read(ctx) == 100.0
    del r.counters["images.frames"], r.counters["images.card_frames"]
    assert read(ctx) is None
