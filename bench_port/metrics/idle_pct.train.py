"""Share of the traced steps' window in which no operation ran on the card,
from the profiler's trace alone. The profiler slows the host, and the
step is host-bound, so this reads well above the unprofiled window's idle
share."""

from bench_port.lib import readers


def read(rec):
    return readers.idle(rec)
