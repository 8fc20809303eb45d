"""Gigabytes of coalition weights a traced round lays out on the mesh's
cards: the program's counter ``eval.place_bytes`` (each distinct piece
once per card, copied or already there)."""

from bench_port.lib import spans


def read(rec):
    return spans.counter_per_round(rec, "eval.place_bytes", 1e-9)
