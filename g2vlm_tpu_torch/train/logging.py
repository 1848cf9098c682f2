"""Logging, step timing and profiler hooks of the training loop (port of
g2vlm_tpu/train/logging.py; the profiler is torch.profiler)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional


def create_logger(log_dir: Optional[str] = None, rank: int = 0) -> logging.Logger:
    logger = logging.getLogger("g2vlm_tpu_torch")
    logger.handlers.clear()
    if rank == 0:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.setLevel(logging.ERROR)
    return logger


class StepTimer:
    """Wall-clock tracking across train steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt > 0:
            self._times.append(dt)
            self._times = self._times[-self.window :]
        return dt

    @property
    def avg_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0


class _ProfileWindow:
    """Holds the torch.profiler run that spans several steps."""

    def __init__(self):
        self.prof = None


_window = _ProfileWindow()


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], step: int, start: int, num: int):
    """Capture a torch.profiler trace of steps [start, start+num) into
    `trace_dir` (one chrome trace file)."""
    active = trace_dir is not None and start <= step < start + num
    if active and step == start:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        _window.prof = profile(activities=acts)
        _window.prof.__enter__()
    try:
        yield
    finally:
        if active and step == start + num - 1 and _window.prof is not None:
            prof, _window.prof = _window.prof, None
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"trace_steps_{start}_{start + num - 1}.json"))


def format_metrics(step: int, metrics: Dict, step_time: float) -> str:
    parts = [f"step {step}"]
    for k in ("loss", "ce", "dl", "grad_norm"):
        if k in metrics:
            parts.append(f"{k}={float(metrics[k]):.4f}")
    extras = [f"{k}={float(v):.4f}" for k, v in metrics.items() if k not in ("loss", "ce", "dl", "grad_norm")]
    if step_time:
        parts.append(f"{step_time*1000:.0f}ms/step")
    return " ".join(parts + extras)
