"""The client steps' share of the card's bf16 peak: the forward's
operations, the backward's input gradients that the loss reaches and the
trainable leaves' weight gradients (``counts.train_step_flops``), over
the measured window, against 989 TFLOP/s."""

from bench_port.lib import readers


def read(rec):
    return readers.mfu(rec)
