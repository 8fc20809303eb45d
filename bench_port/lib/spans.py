"""What the benchmark reads of the program's own spans and counters
(``shapley_vit_tpu_torch.utils.profiling``): the program records them only
while a profiler runs, so they come from the traced rounds. The buffer is
drained once, by the first reader that asks, and kept in the run's facts
for the others. Imported only inside a run; the program only inside these
functions. Every value is per traced round, and None where the program
recorded no such span or counter (a program without them included)."""

from __future__ import annotations

KEY = "program_spans"


def taken(rec):
    """The program's drained buffer, or None (no traced round, or a program
    without the buffer)."""
    if not rec.facts.get("traced_rounds"):
        return None
    if KEY not in rec.facts:
        try:
            from shapley_vit_tpu_torch.utils.profiling import take
        except ImportError:
            take = None
        rec.facts[KEY] = take() if take is not None else None
    return rec.facts[KEY]


def _per_round(rec, names, seconds):
    spans = taken(rec)
    if spans is None or not any(spans.of(n) for n in names):
        return None
    return 1e3 * sum(seconds(spans, n) for n in names) / rec.facts["traced_rounds"]


def self_ms(rec, *names):
    """Host milliseconds a round of the spans ``names``, less their child
    spans."""
    return _per_round(rec, names, lambda s, n: s.self_s(n))


def host_ms(rec, name):
    """Host milliseconds a round of the span ``name``."""
    return _per_round(rec, (name,), lambda s, n: s.total_s(n))


def device_ms(rec, name):
    """Device milliseconds a round of the span ``name``, between its CUDA
    events; None where it ran on no CUDA device."""
    spans = taken(rec)
    seconds = spans.device_s(name) if spans is not None else None
    return None if seconds is None else 1e3 * seconds / rec.facts["traced_rounds"]


def counter_per_round(rec, name, scale=1.0):
    spans = taken(rec)
    if spans is None or name not in spans.counters:
        return None
    return scale * spans.counters[name] / rec.facts["traced_rounds"]
