"""The 90th percentile of the round times on the four-card mesh, from the
measured window of a traced run."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "round_p90_s")
