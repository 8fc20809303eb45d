"""The 90th percentile of the window's round times: a round runs from the
upload of its deltas to the host's Shapley values."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "round_p90_s")
