"""The packed attention kernel's share of its roofline over the traced
rounds (``counts.attention_packed_call``)."""

from bench_port.lib import readers


def read(rec):
    return readers.roofline(rec, "attention", "fused_attention_packed")
