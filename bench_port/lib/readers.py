"""The arithmetic that the metric readers in ``bench_port/metrics/`` share.
Each reader's file names its metric and calls one of these; each returns
None where the run holds nothing to read, never 0 for a share."""

from __future__ import annotations

from bench_port.lib.counts import PEAKS


def fact(rec, name: str, scale: float = 1.0):
    """A number the traffic kind's runner recorded, times ``scale``."""
    v = rec.facts.get(name)
    return None if v is None else scale * v


def mfu(rec):
    """The window's matrix-product operations (``window_flops``) over its
    seconds, against the bf16 peak of the cards used."""
    flops, window = rec.facts.get("window_flops"), rec.facts.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * rec.chips * PEAKS["bfloat16"])


def idle(rec):
    """The share of the traced window in which no operation ran on a card
    (the mean of the cards used): one minus the trace's busy seconds over
    the trace's window. Nothing when the trace ran no operation or reads
    busier than its window (a fault of the reduction, not a reading)."""
    t = rec.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0 or t.busy_s > t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def group_ms_per_unit(rec, group: str, unit: str):
    """Device milliseconds of one kernel group per traced round or step."""
    t, n = rec.trace, rec.facts.get(unit)
    if t is None or not n or t.busy_s <= 0:
        return None
    return 1e3 * t.by_group[group] / n


def roofline(rec, family: str, wrapper: str):
    """A kernel family's share of its roofline over the traced stretch: the
    least time of each call counted from the shapes (its operations over the
    peak or its bytes over the bandwidth, whichever is larger) summed, over
    the family's device time in the trace. Nothing when the wrapper's
    launches are not the calls counted."""
    t = rec.trace
    work = rec.facts.get("traced_work", {}).get(family)
    launched = sum(rec.facts.get("traced_launches", {}).get(wrapper, {}).values())
    if t is None or not work or not work["calls"] or launched != work["calls"]:
        return None
    seconds = t.kernel_seconds(family)
    if seconds <= 0:
        return None
    return 100.0 * work["bound_s"] / seconds
