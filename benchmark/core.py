"""The harness: finds a cell's configuration, traffic mix, driver, limits and
metric readers by the names in BENCHMARK.json, runs set-up and the measured
window, reads the profiler's trace in a traced run, checks the outputs
against the plain reference, and prints the result line.

Layout of the benchmark's folder, each found by name:
  configs/<config file>.json          sizes of a configuration (BENCHMARK.json's `file`)
  traffic/mixes/<traffic>.json        a traffic mix: its parameters and the name of its drivers/ module
  drivers/<driver>.py                 set-up, one request, the output check of a kind of traffic
  limits/<cell>.json                  the limit of each number the cell's check compares
  end_to_end/<metric>.py              read(ctx) of an end-to-end metric
  layer_metrics/<metric>.py           read(ctx) of a per-layer metric; None where it finds nothing
  layer_metrics/<family>.py           the reader of every `<family>.<cell>` metric without a file of its own
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

from .traffic.requests import load_mix

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "g2vlm_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards that the cell asks for."""


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def module_path(kind: str, name: str) -> str:
    """`<kind>/<name>.py`, or where that is missing and the name has a dot,
    the family's reader `<kind>/<part before the first dot>.py`, which then
    serves every metric of the family (`mfu.recon`, `mfu.chat`, ...)."""
    path = os.path.join(BENCH, kind, name + ".py")
    family = os.path.join(BENCH, kind, name.split(".")[0] + ".py")
    return family if not os.path.exists(path) and "." in name and os.path.exists(family) else path


def load_module(kind: str, name: str) -> ModuleType:
    path = module_path(kind, name)
    mod_name = f"benchmark.{kind}.{os.path.basename(path)[:-3]}".replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[mod_name] = mod
    sp.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's runs may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def resolve(s: Dict, cell: str) -> SimpleNamespace:
    """Everything BENCHMARK.json and the folder say about one cell."""
    wl = next((w for w in s["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in s["configs"] if c["name"] == wl["config"])
    mix = load_mix(wl["traffic"])

    def applies(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in s["end_to_end"] if applies(m)]
    moves = {m["name"] for m in e2e}
    layer = [m for m in s["per_layer"] if applies(m) and m["moves"] in moves]
    limits_path = os.path.join(BENCH, "limits", cell + ".json")
    return SimpleNamespace(
        name=cell, workload=wl, config=load_json(os.path.join(ROOT, conf["file"])), mix=mix,
        driver=load_module("drivers", mix["driver"]), end_to_end=e2e, per_layer=layer,
        limits=load_json(limits_path) if os.path.exists(limits_path) else {},
    )


def program_config(c: Dict):
    """The system's G2VLMConfig for a configuration file."""
    import dataclasses

    from g2vlm_tpu_torch import config as pc

    def make(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    top = {k: v for k, v in c.items() if not isinstance(v, dict)}
    return make(pc.G2VLMConfig, dict(top, llm=make(pc.LLMConfig, c["llm"]), vit=make(pc.VitConfig, c["vit"]),
                                     dino=make(pc.DinoConfig, c["dino"]), pi3=make(pc.Pi3HeadConfig, c["pi3"])))


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_SPAN = "bench.window"
SMALL_GAP_US = 10.0


class Trace:
    """Device activity of the traced sub-window (the `bench.window` span),
    from a chrome trace of torch.profiler. Times in seconds."""

    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no bench.window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1)
                if b > a:
                    dev.append((a, b, e["name"], e["cat"]))
        dev.sort()
        self.kernels = [(n, (b - a) * 1e-6) for a, b, n, c in dev if c == "kernel"]
        merged: List[List[float]] = []
        for a, b, _, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in events
                      if e.get("cat") in HOST_CATS and e.get("ph") == "X" and e.get("name") != WINDOW_SPAN)
        starts = [h[0] for h in host]
        import bisect

        by_label: Dict[str, float] = {}
        for a, b in gaps:
            label = f"(gaps under {SMALL_GAP_US:g} us)"
            if b - a >= SMALL_GAP_US:
                label = "(no host op)"
                i = bisect.bisect_right(starts, a) - 1
                for j in range(i, max(-1, i - 5000), -1):
                    if host[j][1] > a:
                        label = host[j][2]
                        break
            by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
        self.idle_gaps = sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:10]
        per_op: Dict[str, float] = {}
        for n, t in self.kernels:
            per_op[n] = per_op.get(n, 0.0) + t
        self.device_ops = sorted(([k, v] for k, v in per_op.items()), key=lambda kv: -kv[1])[:10]

    def kernel_seconds(self, pattern: str) -> float:
        import re

        rx = re.compile(pattern)
        return sum(t for n, t in self.kernels if rx.search(n))

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        return cls(load_json(path)["traceEvents"])


# ---------------------------------------------------------------------------
# what a reader sees
# ---------------------------------------------------------------------------


class Context:
    """What a reader sees. `samples`: one dict per request completed in the
    window outside the profiled sub-window (latency_s, work, info), and
    `window_s` the window's seconds outside it; `traced`: the requests inside
    it, and `trace` its Trace (None in an untraced run)."""

    def __init__(self, cell, samples: List[Dict], window_s: float, setup_s: float, traced: List[int],
                 trace: Optional[Trace], traced_wall_s: float = 0.0):
        self.cell, self.setup_s, self.trace = cell, setup_s, trace
        inside = set(traced)
        self.samples = [s for i, s in enumerate(samples) if i not in inside]
        self.traced = [samples[i] for i in traced]
        self.window_s = window_s - traced_wall_s

    def work(self, key: str, traced: bool = False) -> float:
        return sum(s["work"].get(key, 0.0) for s in (self.traced if traced else self.samples))

    def latencies(self) -> List[float]:
        return [s["latency_s"] for s in self.samples]

    def roofline(self, pattern: str, bound_key: str) -> Optional[float]:
        """Share (%) of the kernels' time that their bound takes, over the traced sub-window."""
        if self.trace is None:
            return None
        t, b = self.trace.kernel_seconds(pattern), self.work(bound_key, traced=True)
        return 100.0 * b / t if t > 0 and b > 0 else None

    def mfu(self) -> Optional[float]:
        from .work.counts import PEAK_BF16_FLOPS

        f = self.work("flops")
        return 100.0 * f / self.window_s / PEAK_BF16_FLOPS if f > 0 and self.window_s > 0 else None

    def idle_share(self) -> Optional[float]:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def info_sum(self, *keys: str) -> Optional[float]:
        vals = [sum(s["info"][k] for k in keys) for s in self.samples if s.get("info")]
        return sum(vals) if vals else None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_process: float, device: str = "cuda",
             overrides: Optional[Dict] = None, fault=None) -> Dict:
    """One run of `cell`: set-up, the window, the check. `overrides` replaces
    parts of the configuration and the mix (the CPU tests' tiny sizes);
    `fault(state)` breaks the system under test after set-up (tests)."""
    import torch

    seed %= 1 << 63  # numpy's generators take no negative seed
    c = resolve(spec(), cell)
    if overrides:
        c.config = dict(c.config, **overrides.get("config", {}))
        c.mix = dict(c.mix, **overrides.get("mix", {}))
    chips = c.workload["chips"]
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise NoDevice(f"cell {cell} needs {chips} CUDA device(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    drv = c.driver
    t_setup = time.perf_counter()
    state = drv.setup(c.config, c.mix, seed, device)
    print(f"set-up: {t_setup - t_process:.3f} s before the cell's set-up (imports), {time.perf_counter() - t_setup:.3f} s "
          f"in it ({', '.join(f'{k} {v:.3f} s' for k, v in getattr(state, 'setup_parts', {}).items())}); "
          f"the process's CPU time so far {time.process_time():.3f} s", file=sys.stderr)
    if fault is not None:
        fault(state)
    prof_at, prof_n = c.mix.get("profile_after", 2), c.mix["profile_requests"]
    prof = span = None
    samples: List[Dict] = []
    traced: List[int] = []
    traced_wall = 0.0
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    i = 0
    while time.perf_counter() - t0 < seconds:
        inp = drv.make_input(state, i)
        if trace and i == prof_at:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
            _sync(device)
            span = record_function(WINDOW_SPAN)
            span.__enter__()
            t_trace = time.perf_counter()
        ts = time.perf_counter()
        out, info = drv.call(state, inp, trace)
        latency = time.perf_counter() - ts
        if span is not None:
            traced.append(i)
        samples.append({"latency_s": latency, "work": drv.work(state, inp, out), "info": info})
        drv.keep(state, i, inp, out)
        i += 1
        if span is not None and len(traced) == prof_n:
            _sync(device)
            traced_wall = time.perf_counter() - t_trace
            span.__exit__(None, None, None)
            prof.stop()
            span = None
    _sync(device)
    window_s = time.perf_counter() - t0
    if span is not None:  # the window closed first
        traced_wall = time.perf_counter() - t_trace
        span.__exit__(None, None, None)
        prof.stop()
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    tr = None
    if prof is not None:
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"bench_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        del prof
        try:
            tr = Trace.from_file(path)
        finally:
            os.remove(path)
    ctx = Context(c, samples, window_s, setup_s, traced, tr, traced_wall)
    drv.release(state)
    checks = drv.check(state, c.limits)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = load_module("layer_metrics" if trace else "end_to_end", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(mem)}
    out = {"correct": bool(checks) and all(v["value"] <= v["limit"] for v in checks.values()),
           "attempted": len(samples), "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    print("latencies ms: " + " ".join(f"{s['latency_s'] * 1e3:.1f}" for s in samples), file=sys.stderr)
    lat = sorted(s["latency_s"] for s in samples)
    if lat:
        print(f"{cell}: {len(lat)} requests in {window_s:.3f} s, latency median {statistics.median(lat) * 1e3:.3f} ms, "
              f"max {lat[-1] * 1e3:.3f} ms; set-up {setup_s:.3f} s", file=sys.stderr)
    out["checks"] = checks
    return out


def print_result(out: Dict) -> None:
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
