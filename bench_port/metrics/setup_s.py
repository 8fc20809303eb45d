"""The set-up time: process start to the first timed round or step."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "setup_s")
