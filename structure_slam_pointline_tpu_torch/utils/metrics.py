"""Structured per-stage metrics: counters, timers and scalar series.

Copy of the `Metrics` registry of the JAX package
(structure_slam_pointline_tpu/utils/metrics.py), kept here so the port
imports nothing of that package, with its process-wide `GLOBAL` registry
and `device_trace`, which records a torch.profiler trace (host ops and,
on a CUDA device, kernels and copies) where the reference records a
jax.profiler one.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List


class Metrics:
    """Process-wide registry: counters, timers (ms), and scalar series."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.timers: Dict[str, List[float]] = defaultdict(list)
        self.series: Dict[str, List[float]] = defaultdict(list)

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc

    def record(self, name: str, value: float) -> None:
        self.series[name].append(float(value))

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].append((time.perf_counter() - t0) * 1000.0)

    def summary(self) -> dict:
        def stats(xs):
            if not xs:
                return {}
            xs = sorted(xs)
            n = len(xs)
            return {
                "n": n,
                "mean": sum(xs) / n,
                "p50": xs[n // 2],
                "p90": xs[min(int(n * 0.9), n - 1)],
                "max": xs[-1],
            }

        return {
            "counters": dict(self.counters),
            "timers_ms": {k: stats(v) for k, v in self.timers.items()},
            "series": {k: stats(v) for k, v in self.series.items()},
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()
        self.series.clear()


GLOBAL = Metrics()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace around a region, written to
    `log_dir/trace.json` (Chrome trace format) when the region ends."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


__all__ = ["Metrics", "GLOBAL", "device_trace"]
