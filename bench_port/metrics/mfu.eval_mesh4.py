"""``mfu.eval`` on the four-card mesh: the useful operations (no padded
rows) over the measured window, against four times 989 TFLOP/s."""

from bench_port.lib import readers


def read(rec):
    return readers.mfu(rec)
