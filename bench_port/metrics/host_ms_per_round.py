"""Host milliseconds a round spends outside the coalition evaluation calls:
the delta upload, the Game and the estimator's sampling and scoring."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "host_s_per_round", 1e3)
