"""Host milliseconds a traced round spends laying the folded coalition
weights out on the mesh's cards, padding included: the program's span
``svt.eval.place``."""

from bench_port.lib import spans


def read(rec):
    return spans.host_ms(rec, "eval.place")
