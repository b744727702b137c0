"""Tracing and timing — the observability layer (port of
``fastllama_tpu/utils/profiling.py``).

:class:`StepTimer` is the C++ engine's microsecond wall-clock ``Timer``
generalized to named phases and percentiles.  :func:`trace` records a
``torch.profiler`` trace of the host and, with a card, of its kernels
(CUDA activity), and writes it to ``log_dir`` as a Chrome/Perfetto JSON
trace (``trace.json``) plus a table of device time by kernel
(``kernels.txt``).  :func:`annotate` names a region in it.

Usage::

    from fastllama_tpu_torch.utils.profiling import trace, StepTimer

    with trace("/tmp/trace"):          # device + host trace
        engine.generate(...)

    t = StepTimer()
    with t.step("prefill"): ...
    with t.step("decode"): ...
    print(t.report())

CLI: ``--profile-dir DIR`` wraps the whole run.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the region into ``log_dir``: CPU
    activity always, CUDA activity where a card is present.  The trace is
    written when the region ends, also when it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        sort = ("self_device_time_total" if torch.cuda.is_available()
                else "self_cpu_time_total")
        with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the host timeline)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """Wall-clock step timing with per-phase stats — the C++ engine's
    ``Timer`` generalized to named phases and percentiles."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(name, []).append(
                time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples.setdefault(name, []).append(seconds)

    def stats(self, name: str) -> dict:
        xs = sorted(self._samples.get(name, ()))
        if not xs:
            return {}
        n = len(xs)
        return {
            "count": n,
            "total_s": sum(xs),
            "mean_ms": 1e3 * sum(xs) / n,
            "min_ms": 1e3 * xs[0],
            "p50_ms": 1e3 * xs[n // 2],
            "p99_ms": 1e3 * xs[min(n - 1, int(n * 0.99))],
            "max_ms": 1e3 * xs[-1],
        }

    def report(self) -> str:
        lines = []
        for name in self._samples:
            s = self.stats(name)
            lines.append(
                f"{name}: n={s['count']} mean={s['mean_ms']:.2f}ms "
                f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
                f"max={s['max_ms']:.2f}ms total={s['total_s']:.3f}s")
        return "\n".join(lines)
