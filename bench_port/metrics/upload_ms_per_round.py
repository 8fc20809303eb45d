"""Host milliseconds a traced round spends uploading its client deltas:
the self time of the program's spans ``svt.tree.stack_host`` (stacking the
host trees) and ``svt.tree.to_device`` (the copy to the card)."""

from bench_port.lib import spans


def read(rec):
    return spans.self_ms(rec, "tree.stack_host", "tree.to_device")
