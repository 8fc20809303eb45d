"""The fused MLP kernel's share of its roofline over the traced rounds
(``counts.mlp_block_call``: its operations over 989 TFLOP/s or its bytes
over 3.35 TB/s, whichever is larger, a call)."""

from bench_port.lib import readers


def read(rec):
    return readers.roofline(rec, "mlp_block", "fused_mlp_block")
