"""What the benchmark takes from the program (``shapley_vit_tpu_torch``)
whatever the model family: its kernel wrappers' launch counters, the cards'
peak memory, a wait for the cards, and a quiet logger for its estimator. A
family's spec and forward are in ``families/<reference>.py``. Imported only
inside a run, never by the harness's frame."""

from __future__ import annotations

import importlib
import logging
from collections import Counter
from typing import Dict, Sequence, Tuple


def quiet_logger() -> logging.Logger:
    """A logger that drops the estimator's per-round info lines."""
    log = logging.getLogger("bench_port.program")
    log.setLevel(logging.WARNING)
    log.propagate = False
    return log


def launch_counts(wrappers: Sequence[Tuple[str, str]]) -> Dict[str, Counter]:
    """A copy of each kernel wrapper's launches by kernel, keyed by the
    wrapper's name. ``wrappers``: the family's ``WRAPPERS``, each a
    ``(module, attribute)`` of the program."""
    out = {}
    for module, attr in wrappers:
        w = getattr(importlib.import_module(module), attr)
        out[w.__name__] = Counter(w.launches_by)
    return out


def launches_between(before: Dict[str, Counter], after: Dict[str, Counter]) -> Dict[str, dict]:
    return {w: {k: n - before[w].get(k, 0) for k, n in after[w].items() if n != before[w].get(k, 0)}
            for w in after}


def peak_memory(devices) -> int:
    import torch

    return max((int(torch.cuda.max_memory_allocated(d)) for d in devices if d.type == "cuda"),
               default=0)


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
