"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, reduced to device busy time, device time by kernel and by group, and
the device's idle gaps labelled by what the host was doing.

The grouping of kernel names is the one of ``chip_smoke.py``'s ``profile``
phase: the port's kernels by family (a name containing one of the model
family's ``KERNEL_FAMILIES`` followed by ``_``; the ViT's are
``patch_embed``, ``attention`` and ``mlp_block``), the matrix products
outside them (``PRODUCT_KERNELS``: cuBLAS, cuBLASLt, CUTLASS) and
everything else (elementwise work, reductions, copies).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bench.traced_window"
HOST_PREFIX = "bench."
PRODUCT_KERNELS = ("gemm", "nvjet", "cutlass", "sm90", "xmma")
OUTSIDE = ("matrix_products", "other")


def group_of(name: str, families: Sequence[str]) -> str:
    """The group of a kernel named ``name``: the first of the model family's
    kernel ``families`` it holds, else a matrix product, else ``other``."""
    for g in families:
        if g + "_" in name:
            return g
    low = name.lower()
    if any(k in low for k in PRODUCT_KERNELS):
        return "matrix_products"
    return "other"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class TraceSummary:
    """Seconds throughout. ``busy_s``: mean over the cards used of the time
    in which an operation ran on the card; ``by_name``: device seconds by
    operation name (over all cards); ``by_group``: the same by group;
    ``idle_by_host``: idle seconds of the cards, summed, by the host activity
    at each gap."""

    window_s: float
    busy_s: float
    by_name: Dict[str, float]
    by_group: Dict[str, float]
    idle_by_host: Dict[str, float]

    def kernel_seconds(self, family: str) -> float:
        return sum(s for n, s in self.by_name.items() if family + "_" in n)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


class TracedWindow:
    """``with TracedWindow(devices, families) as tw: ...`` profiles the
    block; the window opens and closes with every card idle. ``tw.summary()``
    reduces the trace, grouping kernels by the model family's kernel
    ``families``."""

    def __init__(self, devices, families: Sequence[str]):
        self.devices = list(devices)
        self.families = tuple(families)
        self.prof = None
        self._rf = None

    def _sync(self):
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in self.devices) and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._rf = record_function(WINDOW)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[TraceSummary]:
        return summarize(self.prof.events(), [d.index or 0 for d in self.devices
                                              if d.type == "cuda"], self.families)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def summarize(events, device_indices: List[int], families: Sequence[str]) -> Optional[TraceSummary]:
    """Reduce a profiler's events, kernels grouped by the model family's
    kernel ``families``. None when the window span is missing."""
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    host_labels = {e.name for e in events if e.name.startswith(HOST_PREFIX) and not _is_device(e)}
    per_dev: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    by_name: Dict[str, float] = defaultdict(float)
    by_group: Dict[str, float] = {g: 0.0 for g in tuple(families) + OUTSIDE}
    for e in events:
        # the GPU side of a host annotation spans kernels; it is not one
        if not _is_device(e) or e.name in host_labels:
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        per_dev[int(e.device_index)].append((s, t))
        by_name[e.name] += (t - s) / 1e6
        by_group[group_of(e.name, families)] += (t - s) / 1e6
    window_s = (w1 - w0) / 1e6
    merged = {d: merge(per_dev.get(d, [])) for d in device_indices}
    busy = {d: sum(t - s for s, t in iv) / 1e6 for d, iv in merged.items()}
    busy_s = sum(busy.values()) / len(busy) if busy else 0.0
    gaps = []
    for d, iv in merged.items():
        prev = w0
        for s, t in iv:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if w1 > prev:
            gaps.append((prev, w1))
    idle_by_host = label_gaps(events, win[0], gaps)
    return TraceSummary(window_s=window_s, busy_s=busy_s, by_name=dict(by_name), by_group=by_group,
                        idle_by_host=idle_by_host)


SMALL_GAP_US = 20.0


def label_gaps(events, window_event, gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Idle seconds by the host activity at each gap's midpoint: the
    innermost benchmark span and the innermost operation on the thread that
    opened the window. Gaps under ``SMALL_GAP_US`` (between back-to-back
    operations) are summed under one label."""
    thread = window_event.thread
    host = [e for e in events if not _is_device(e) and e.thread == thread and e.name != WINDOW]
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                 if not e.name.startswith(HOST_PREFIX))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                   if e.name.startswith(HOST_PREFIX))
    op_starts = [h[0] for h in ops]
    span_starts = [h[0] for h in spans]

    def innermost(items, starts, t, limit):
        # the nearest event that began before t and still runs at t is the
        # innermost of the nested events covering t
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and limit > 0:
            if items[j][1] >= t:
                return items[j][2]
            j -= 1
            limit -= 1
        return None

    out: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        if t - s < SMALL_GAP_US:
            out[f"between back-to-back operations (gaps under {SMALL_GAP_US:g} us)"] += (t - s) / 1e6
            continue
        mid = 0.5 * (s + t)
        label = " / ".join(x for x in (innermost(spans, span_starts, mid, len(spans)),
                                       innermost(ops, op_starts, mid, 256)) if x)
        out[label or "host outside any operation"] += (t - s) / 1e6
    return dict(out)
