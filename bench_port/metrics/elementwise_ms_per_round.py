"""Device milliseconds a traced round spends outside the port's kernels
and the matrix-product libraries: LayerNorm as torch ops, adds, casts,
reductions and copies (the ``other`` group of the trace's grouping)."""

from bench_port.lib import readers


def read(rec):
    return readers.group_ms_per_unit(rec, "other", "traced_rounds")
