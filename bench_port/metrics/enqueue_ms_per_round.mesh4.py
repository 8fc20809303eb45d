"""Host milliseconds a traced round spends queueing every cell's forwards
from the one host thread: the program's span ``svt.eval.enqueue``."""

from bench_port.lib import spans


def read(rec):
    return spans.host_ms(rec, "eval.enqueue")
