"""Tracing / profiling (the port of ``shapley_vit_tpu/utils/profiling.py``).

Three layers:
  * :func:`trace` — a ``torch.profiler`` trace (CPU and CUDA activities,
    exported as a Chrome trace) around a Shapley round or any block;
  * :func:`span` and :func:`count` — the program's own spans and counters,
    recorded only while a torch profiler records on the calling thread
    (``trace``, or any other ``torch.profiler.profile``). A span is an
    ``svt.<name>`` event in the profiler's trace, on its clock, and a record
    in a bounded in-memory buffer that :func:`take` drains;
  * :class:`StepTimer` — always-on wall-clock spans summarized into a
    metrics dict (feeds CSVLogger.scalar_summary); each of its spans is also
    a :func:`span`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "svt."
# records the buffer keeps before it drops new ones (and counts them)
MAX_RECORDS = 65536

# whether a torch profiler records on this thread: the one check a span
# makes when none does
recording = torch.autograd._profiler_enabled


@dataclass(frozen=True)
class SpanRecord:
    """One closed span. Times in nanoseconds on ``time.perf_counter_ns``;
    ``child_ns`` is the time its child spans cover; ``device_s`` the time
    between the span's two CUDA events on its device's stream, or None."""

    name: str
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int
    child_ns: int
    device_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_seconds(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9


@dataclass
class Spans:
    """What :func:`take` drains: the closed spans in the order they closed,
    the counters, and how many spans the bound dropped."""

    spans: List[SpanRecord]
    counters: Dict[str, float]
    dropped: int = 0

    def of(self, name: str) -> List[SpanRecord]:
        return [s for s in self.spans if s.name == name]

    def total_s(self, name: str) -> float:
        return sum(s.seconds for s in self.of(name))

    def self_s(self, name: str) -> float:
        """The span's seconds less the seconds its child spans cover."""
        return sum(s.self_seconds for s in self.of(name))

    def device_s(self, name: str) -> Optional[float]:
        """Device seconds of the spans timed on a CUDA device; None when
        none was."""
        timed = [s.device_s for s in self.of(name) if s.device_s is not None]
        return sum(timed) if timed else None


class _Buffer:
    def __init__(self, limit: int):
        self.limit = limit
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.records: list = []
            self.counters: Dict[str, float] = defaultdict(float)
            self.dropped = 0

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, record: tuple) -> None:
        with self.lock:
            if len(self.records) < self.limit:
                self.records.append(record)
            else:
                self.dropped += 1

    def count(self, name: str, value: float) -> None:
        with self.lock:
            self.counters[name] += value

    def drain(self):
        with self.lock:
            out = self.records, dict(self.counters), self.dropped
            self.records, self.counters, self.dropped = [], defaultdict(float), 0
        return out


_BUFFER = _Buffer(MAX_RECORDS)


class _Span:
    __slots__ = ("name", "device", "parent", "frame", "rf", "events", "t0")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = _BUFFER.stack()
        self.parent = stack[-1][0] if stack else None
        self.frame = [self.name, 0]  # name, nanoseconds covered by children
        stack.append(self.frame)
        self.rf = _RecordFunctionFast(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.rf.__exit__(*exc)
        stack = _BUFFER.stack()
        stack.pop()
        if stack:
            stack[-1][1] += t1 - self.t0
        _BUFFER.add((self.name, self.parent, threading.get_ident(), self.t0, t1, self.frame[1],
                     self.events))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None):
    """``with span("eval.place"):`` — while a torch profiler records on this
    thread: a function-scope ``RecordFunction`` named ``svt.<name>`` (a host
    event in the trace; no device-side annotation), and a record of the
    name, the enclosing span, the thread and the start and end on the host
    clock. With ``device`` a CUDA device, two timing events on its current
    stream as well, resolved only by :func:`take`, so the span never waits
    for the device. With no profiler it records nothing."""
    if not recording():
        return _OFF
    return _Span(name, device)


def count(name: str, value: float = 1.0) -> None:
    """Add ``value`` to a named counter, under the same condition as
    :func:`span`."""
    if recording():
        _BUFFER.count(name, value)


def take() -> Spans:
    """Drain the buffer. A span timed on a CUDA device waits here for its
    end event."""
    records, counters, dropped = _BUFFER.drain()
    spans = []
    for name, parent, thread, t0, t1, child, events in records:
        device_s = None
        if events is not None:
            events[1].synchronize()
            device_s = events[0].elapsed_time(events[1]) / 1e3
        spans.append(SpanRecord(name, parent, thread, t0, t1, child, device_s))
    return Spans(spans, counters, dropped)


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """Profiler context: ``with trace('exp/profile'):`` records everything
    run inside, the program's spans included, and writes
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto). Clears the span
    buffer on entry. No-op when disabled or log_dir is None."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    _BUFFER.clear()
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

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a block on the host clock, and open a :func:`span` of the
        same name. CUDA work runs asynchronously: the span covers the
        device's work only if the block ends by waiting for it (the
        evaluator's host transfer of its results does)."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def times(self, name: str) -> list:
        """Every duration recorded under a span, in seconds, in order."""
        return list(self._spans[name])

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self._spans.items():
            out[name] = {
                "count": len(times),
                "total_s": sum(times),
                "mean_s": sum(times) / len(times),
                "max_s": max(times),
            }
        return out

    def log_to(self, csv_logger, step: int) -> None:
        """Emit every span mean into a CSVLogger metrics stream."""
        for name, stats in self.summary().items():
            csv_logger.scalar_summary(f"time/{name}", stats["mean_s"], step)
