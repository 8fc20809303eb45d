"""Validation images through coalition models per second of the window:
every round's distinct coalitions times the validation images, over the
time from the window's start to the end of its last whole round."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "images_per_s")
