"""Spans and counters of the port's recon and chat calls, on the profiler's clock.

    from g2vlm_tpu_torch.utils import tracing

    with tracing.span("decoder"):
        ...
    tracing.count("upload.bytes", n)

A span records while a `torch.profiler` run is recording, or inside
`tracing.record()`. Otherwise `span` hands back one shared no-op and `count`
returns at once: a flag check, no allocation. A recorded span is also a
`torch.profiler.record_function` range, so it lands in a profiler trace as a
`user_annotation` on the clock of the device's kernels. It holds its name, the
id of its request (the top-level span it runs under, shared by every span of
that call), its parent (a stack per thread), its host start and end
(`time.perf_counter_ns`) and, where CUDA is in use, a pair of timing events on
the current stream. The recorder never synchronises: a span's `device_ms` is
read once the caller's own synchronisation has completed its events, and no
event is recorded while the stream captures a CUDA graph. A counter adds to
the request of the innermost open span; with none open it is dropped. A count
may be a tensor on the device: it is added there and read when summarised, so
counting it costs no host sync.

The last `KEEP` requests are kept; `summary()` and `requests()` read them.

Spans of the port: `recon` and `chat` (top level), `input`, `dino`, `vit`,
`decoder`, `heads`, `host_images`, `upload`, `prefill`, `cache`, `decode`,
`decode.first`, and in the "mla_moe" decoder's sparse layers `moe.route` and
`moe.experts` (ops/moe.py); counters `upload.bytes`, `decode.steps` and
`decode.fused_steps` (the decode loop's steps, and those on the fused decode
kernels, inference/decoding.py), `moe.tokens.l<layer>.max`
and `moe.tokens.l<layer>.mean` (the tokens routed to the busiest expert of each
MoE layer, a device count, and to the mean one).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

KEEP = 1024  # finished requests kept


class _Off:
    """The span handed out while nothing records."""

    host_s = None
    device_ms = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span; `children` in the order they ran, `counters` on a
    request's top-level span only."""

    __slots__ = ("name", "rid", "parent", "children", "counters", "t0", "t1", "_rec", "_rf", "_ev", "_ms")

    def __init__(self, rec: "Recorder", name: str):
        self.name, self._rec = name, rec
        self.children: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.t0 = self.t1 = 0
        self._ev = self._ms = None

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self.parent = stack[-1] if stack else None
        self.rid = self.parent.rid if self.parent is not None else next(self._rec._ids)
        if self.parent is not None:
            self.parent.children.append(self)
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._ev is not None:
            if torch.cuda.is_current_stream_capturing():
                self._ev = None
            else:
                self._ev[1].record()
        self._rf.__exit__(*exc)
        stack = self._rec._stack()
        stack.pop()
        if self.parent is None:
            self._rec._finish(self)
        return False

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def device_ms(self) -> Optional[float]:
        """The device time between the span's two events; None on the CPU, or
        while the device has not reached the second event yet."""
        if self._ms is None and self._ev is not None and self._ev[1].query():
            self._ms = self._ev[0].elapsed_time(self._ev[1])
            self._ev = None
        return self._ms

    def walk(self):
        """This span and every span under it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()


class Recorder:
    """The spans and counters of one process (the module's functions use one
    shared instance)."""

    def __init__(self, keep: int = KEEP):
        self._on = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._done: collections.deque = collections.deque(maxlen=keep)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, root: Span) -> None:
        with self._lock:
            self._done.append(root)

    def span(self, name: str):
        return Span(self, name) if self._on or torch.autograd._profiler_enabled() else OFF

    def recording(self) -> bool:
        """Whether spans and counters record now: for counts that cost device work to make."""
        return bool(self._on or torch.autograd._profiler_enabled())

    def count(self, name: str, n) -> None:
        if not (self._on or torch.autograd._profiler_enabled()):
            return
        stack = self._stack()
        if stack:
            c = stack[0].counters
            c[name] = c.get(name, 0) + n

    @contextlib.contextmanager
    def record(self):
        """Record spans and counters in this block, with or without a profiler."""
        with self._lock:
            self._on += 1
        try:
            yield
        finally:
            with self._lock:
                self._on -= 1

    def requests(self) -> List[Span]:
        """The kept requests' top-level spans, oldest first."""
        with self._lock:
            return list(self._done)

    def clear(self) -> None:
        with self._lock:
            self._done.clear()

    def summary(self, ids: Optional[Iterable[int]] = None) -> Dict[str, Dict]:
        """The kept requests (those of the request ids `ids`, where given),
        grouped by their top-level span's name:
        `requests` {top: how many}; `spans` {(top, name): count (spans in all),
        and the mean a request of host_ms, device_ms, self_host_ms and
        self_device_ms, self time being the span's less its children's};
        `counters` {(top, name): the mean a request}. A device mean is None
        unless every such span has its device time (on the CPU, never)."""
        reqs = self.requests()
        if ids is not None:
            ids = set(ids)
            reqs = [r for r in reqs if r.rid in ids]
        n: Dict[str, int] = collections.Counter(r.name for r in reqs)
        acc: Dict[Tuple[str, str], Dict] = {}
        counters: Dict[Tuple[str, str], float] = {}
        for r in reqs:
            for k, v in r.counters.items():
                counters[(r.name, k)] = counters.get((r.name, k), 0.0) + float(v) / n[r.name]
            for s in r.walk():
                a = acc.setdefault((r.name, s.name), {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                                                       "self_host_ms": 0.0, "self_device_ms": 0.0})
                a["count"] += 1
                host = s.host_s * 1e3
                a["host_ms"] += host / n[r.name]
                a["self_host_ms"] += (host - sum(c.host_s for c in s.children) * 1e3) / n[r.name]
                dev = [s.device_ms] + [c.device_ms for c in s.children]
                if a["device_ms"] is None or None in dev:
                    a["device_ms"] = a["self_device_ms"] = None
                else:
                    a["device_ms"] += dev[0] / n[r.name]
                    a["self_device_ms"] += (dev[0] - sum(dev[1:])) / n[r.name]
        return {"requests": dict(n), "spans": acc, "counters": counters}


_recorder = Recorder()
span = _recorder.span
count = _recorder.count
recording = _recorder.recording
record = _recorder.record
requests = _recorder.requests
clear = _recorder.clear
summary = _recorder.summary
