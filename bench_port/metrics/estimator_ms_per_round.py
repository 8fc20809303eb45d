"""Host milliseconds a traced round spends in the estimator outside the
coalition evaluations: the self time of the program's span ``svt.estimator``
(sampling, the Game's bookkeeping, scoring), less its ``svt.game.evaluate``."""

from bench_port.lib import spans


def read(rec):
    return spans.self_ms(rec, "estimator")
