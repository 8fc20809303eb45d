"""Running-average meters (reference utils/metrics.py:7-62).

A copy of ``shapley_vit_tpu/utils/metrics.py``: the port imports nothing of
the JAX package, so it keeps its own copy."""

from __future__ import annotations


class AverageMeter:
    """Tracks value/avg/sum/count (reference utils/metrics.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.value = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.value = value
        self.sum += value * n
        self.count += n
        self.avg = self.sum / self.count


class AverageMeterList:
    """A fixed-length list of meters updated elementwise (reference
    utils/metrics.py AverageMeterList)."""

    def __init__(self, num: int):
        self.num = num
        self.meters = [AverageMeter() for _ in range(num)]

    def reset(self):
        for m in self.meters:
            m.reset()

    def update(self, values, n: int = 1):
        assert len(values) == self.num
        for m, v in zip(self.meters, values):
            m.update(v, n)

    @property
    def avg(self):
        return [m.avg for m in self.meters]

    @property
    def value(self):
        return [m.value for m in self.meters]

    @property
    def sum(self):
        return [m.sum for m in self.meters]
