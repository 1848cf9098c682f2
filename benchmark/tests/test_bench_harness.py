"""The harness: BENCHMARK.json within the contract, everything found by name
from data (a new cell and metric need only new files and entries), the
result line, the refusal to run without a card, and the import guard."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = core.spec()


def _line(text: str, limit: int = 200) -> bool:
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    s = SPEC
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and all(_line(w) for w in s["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(core.ROOT, c["file"]))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(core.BENCH, "traffic", "mixes", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(core.BENCH, "limits", w["name"] + ".json"))
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(core.module_path("end_to_end", m["name"]))
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"]) and UNIT.match(m["unit"])
        assert os.path.exists(core.module_path("layer_metrics", m["name"]))
    for w in s["workloads"]:
        c = core.resolve(s, w["name"])
        assert {m["name"] for m in c.end_to_end} > {"setup_s"} and c.per_layer


def test_a_family_reader_serves_metrics_without_a_file_of_their_own():
    assert core.module_path("layer_metrics", "mfu.recon") == os.path.join(core.BENCH, "layer_metrics", "mfu.py")
    assert core.module_path("layer_metrics", "chat.host_ms").endswith("chat.host_ms.py")
    a, b = core.load_module("layer_metrics", "mfu.recon"), core.load_module("layer_metrics", "mfu.chat")
    assert a is b and a.read.__module__ == "benchmark.layer_metrics.mfu"
    assert not os.path.exists(core.module_path("layer_metrics", "no_such.metric"))


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert "g2vlm_tpu_torch" not in core.forbidden_modules()
    for name in ("jax", "g2vlm_tpu.models", "optax", "flax.linen", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == ["flax", "g2vlm_tpu", "jax", "jaxlib", "optax"]


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "recon-32v", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == "" and "CUDA" in r.stderr


def test_run_in_a_folder_without_the_system_fails(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import core; from benchmark.tests.conftest "
            "import tiny_config, TINY_MIX; core.run_cell('recon-32v', 1, 0.5, False, time.perf_counter(), "
            "device='cpu', overrides={'config': tiny_config(), 'mix': TINY_MIX['recon-32v']})")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and "g2vlm_tpu_torch" in r.stderr and r.stdout.strip() == ""


DUMMY_DRIVER = '''
import time


def setup(cfg, mix, seed, device):
    return {"n": 0, "step": mix["step_s"]}


def make_input(st, i):
    return i


def call(st, inp, trace):
    time.sleep(st["step"])
    return inp, None


def work(st, inp, out):
    return {"items": 1}


def keep(st, i, inp, out):
    st["n"] += 1


def release(st):
    pass


def check(st, limits):
    return {"kept": {"value": float(st["n"] == 0), "limit": limits["kept"]}}
'''


def test_a_new_cell_and_metric_need_only_new_files_and_entries(tmp_path):
    """A configuration, a mix with its driver, the cell's limits, an end-to-end
    metric and a per-layer metric are added as new files and entries; no file
    of the harness changes."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy"}))
    (b / "traffic" / "mixes" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "dummy", "step_s": 0.01, "profile_after": 1, "profile_requests": 3}))
    (b / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (b / "limits" / "dummy-cell.json").write_text(json.dumps({"kept": 0.5}))
    (b / "end_to_end" / "items_per_s.py").write_text("def read(ctx):\n    return ctx.work('items') / ctx.window_s\n")
    (b / "layer_metrics" / "dummy.idle.py").write_text("def read(ctx):\n    return ctx.idle_share()\n")
    s = json.loads(json.dumps(SPEC))
    s["configs"].append({"name": "dummy", "source": "https://example.org/dummy", "file": "benchmark/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    s["end_to_end"].append({"name": "items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["dummy-cell"]})
    s["per_layer"].append({"name": "dummy.idle", "unit": "%", "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "items_per_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    before = {p: open(os.path.join(core.BENCH, p)).read() for p in ("core.py", "run.py")}
    code = ("import sys, time, json; sys.path.insert(0, '.'); from benchmark import core; "
            "[core.print_result(core.run_cell('dummy-cell', 7, 0.3, t, time.perf_counter(), device='cpu')) "
            "for t in (False, True)]")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    plain, traced = [json.loads(x) for x in r.stdout.strip().splitlines() if x.startswith("{")]
    assert set(plain["metrics"]) == {"items_per_s", "setup_s"} and plain["correct"] is True
    assert plain["metrics"]["items_per_s"]["unit"] == "items/s" and plain["attempted"] >= 10
    assert list(plain)[-1] == "checks" and plain["checks"]["kept"] == {"value": 0.0, "limit": 0.5}
    assert set(traced["metrics"]) == {"dummy.idle"} and traced["metrics"]["dummy.idle"]["value"] == 100.0
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced
    assert before == {p: open(os.path.join(b, p)).read() for p in ("core.py", "run.py")}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_of_a_tiny_recon_run(tiny, trace):
    import time

    out = core.run_cell("recon-32v", 3000000001, 0.5, trace, time.perf_counter(), device="cpu",
                        overrides=tiny("recon-32v", "float32"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    want = {"mfu.recon", "device_idle.recon"} if trace else {"recon_frames_per_s", "setup_s"}
    assert set(out["metrics"]) == want
    assert all(v["value"] < 1e-3 for v in out["checks"].values())
