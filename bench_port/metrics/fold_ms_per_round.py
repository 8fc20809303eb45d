"""Device milliseconds a traced round spends materializing and folding
the coalitions' LoRA into dense q/v kernels: the program's span
``svt.eval.fold``, timed by CUDA events on the base's card. Nothing on the
CPU."""

from bench_port.lib import spans


def read(rec):
    return spans.device_ms(rec, "eval.fold")
