"""Training images stepped per second of the window, to the end of its
last step (a host read of the loss)."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "images_per_s")
