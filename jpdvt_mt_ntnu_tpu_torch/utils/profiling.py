"""Tracing and step timing.

Counterpart of ``jpdvt_mt_ntnu_tpu/utils/profiling.py``. The reference
times steps per second behind a ``torch.cuda.synchronize`` fence
(train_JPDVT.py:379-391); here :func:`trace` records a ``torch.profiler``
trace (CPU and, where there is a card, CUDA activity) into a Chrome trace
file, :class:`StepTimer` counts fenced steps, and :func:`measure` splits a
callable's first call from its steady calls. The fence is
``torch.cuda.synchronize`` for a result on the card and nothing on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch


def fence(out: Any) -> None:
    """Wait for the card's work behind ``out`` (a tensor, or a dict, list
    or tuple of them); nothing for results on the CPU."""
    if isinstance(out, dict):
        out = list(out.values())
    items = out if isinstance(out, (list, tuple)) else [out]
    for dev in {t.device for t in items if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("prof/"): run_steps()`` writes ``prof/trace.json``
    (Chrome trace format: ``chrome://tracing`` or Perfetto) and yields the
    profiler, whose ``key_averages()`` tabulates the run."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Steps per second over a window, each step fenced on its result."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._steps = 0

    def step(self, fence_on: Any = None) -> None:
        """Count one step; pass its result to wait for the card's work."""
        if fence_on is not None:
            fence(fence_on)
        self._steps += 1

    def rate(self, reset: bool = True) -> float:
        dt = time.perf_counter() - self._start
        rate = self._steps / dt if dt > 0 else 0.0
        if reset:
            self.reset()
        return rate


def measure(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> dict[str, float]:
    """First call against steady calls of ``fn(*args)``: {"compile_s": the
    first call, "steady_s": the mean of ``iters`` calls fenced once at the
    end, "per_sec": 1 / steady_s}."""
    t0 = time.perf_counter()
    out = fn(*args)
    fence(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        fence(fn(*args))
    t1 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    fence(out)
    steady = (time.perf_counter() - t1) / iters
    return {"compile_s": compile_s, "steady_s": steady,
            "per_sec": (1.0 / steady) if steady > 0 else float("inf")}
