"""Tracing / profiling (the port of ``shapley_vit_tpu/utils/profiling.py``).

Two layers:
  * :func:`trace` — a ``torch.profiler`` trace (CPU and CUDA activities,
    exported as a Chrome trace) around a Shapley round or any block;
  * :class:`StepTimer` — lightweight wall-clock spans with named counters,
    summarized into a metrics dict (feeds CSVLogger.scalar_summary).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """Profiler context: ``with trace('exp/profile'):`` records everything
    run inside and writes ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto). No-op when disabled or log_dir is None."""
    if not enabled or not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def process_rss_mb() -> float:
    """Resident set size of this process in MB (0.0 where /proc is absent).
    The service exports it per round (``health/rss_mb``) and recycles the
    process at ``max_rss_mb``."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class StepTimer:
    """Named wall-clock spans with running stats.

    >>> t = StepTimer()
    >>> with t.span("coalition_eval"):
    ...     ...
    >>> t.summary()["coalition_eval"]["mean_s"]
    """

    def __init__(self):
        self._spans: Dict[str, list] = defaultdict(list)
        self._counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a block on the host clock. CUDA work runs asynchronously:
        the span covers the device's work only if the block ends by waiting
        for it (the evaluator's host transfer of its results does)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def times(self, name: str) -> list:
        """Every duration recorded under a span, in seconds, in order."""
        return list(self._spans[name])

    def count(self, name: str, value: float = 1.0):
        self._counters[name] += value

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self._spans.items():
            out[name] = {
                "count": len(times),
                "total_s": sum(times),
                "mean_s": sum(times) / len(times),
                "max_s": max(times),
            }
        for name, value in self._counters.items():
            out[name] = {"count": value}
        return out

    def throughput(self, span_name: str, units: float) -> float:
        """units processed per second over a span's total time."""
        total = sum(self._spans[span_name])
        return units / total if total > 0 else 0.0

    def log_to(self, csv_logger, step: int) -> None:
        """Emit every span mean into a CSVLogger metrics stream."""
        for name, stats in self.summary().items():
            if "mean_s" in stats:
                csv_logger.scalar_summary(f"time/{name}", stats["mean_s"], step)
