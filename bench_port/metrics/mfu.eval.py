"""The coalition forwards' share of the card's bf16 peak: their matrix
products' operations (patch, q/k/v/out, QK^T, PV, fc1, fc2, classifier;
two per multiply-add) over the measured window, against 989 TFLOP/s."""

from bench_port.lib import readers


def read(rec):
    return readers.mfu(rec)
