"""The yardstick's arithmetic that every model family shares: published
peaks, the least time of a piece of work, and the operations and bytes of
one call of the port's hand kernels, computed from its shapes. A family's
own counts (a whole evaluation call, a training step, which kernel calls a
block makes) are in ``families/<reference>.py``.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity). The
fused MLP's and the packed attention's operations and bytes are those of the
port's kernel table (``chip_smoke.py``, ``phase_kernels``): two operations
per multiply-add; each input byte read once and each output byte written
once.
"""

from __future__ import annotations

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12, "bytes": 3.35e12}


def bound_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations over
    the dtype's peak and the bytes over the memory rate."""
    return max(flops / PEAKS[dtype], nbytes / PEAKS["bytes"])


def mlp_block_call(tokens: int, hidden: int, mlp_dim: int, itemsize: int = 2):
    """(operations, bytes) of one fused MLP block call over ``tokens`` rows:
    LN, fc1, GELU, fc2 and the residual."""
    flops = 4.0 * tokens * hidden * mlp_dim
    nbytes = (2 * tokens * hidden + 2 * hidden * mlp_dim + mlp_dim + 3 * hidden) * itemsize
    return flops, nbytes


def attention_packed_call(sequences: int, seq_len: int, hidden: int, itemsize: int = 2):
    """(operations, bytes) of one packed attention call over ``sequences``
    sequences of ``seq_len`` tokens and ``hidden`` columns (all heads):
    QK^T and PV; q, k, v read and the context written."""
    flops = 4.0 * sequences * seq_len * seq_len * hidden
    nbytes = 4.0 * sequences * seq_len * hidden * itemsize
    return flops, nbytes
