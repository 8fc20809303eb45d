"""Host milliseconds a traced round spends reading the cells' sums back,
which waits on one card after another: the program's span
``svt.eval.readback``."""

from bench_port.lib import spans


def read(rec):
    return spans.host_ms(rec, "eval.readback")
