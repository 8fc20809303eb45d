"""Logging: one structured logger + CSV experiment log.

The parts of ``shapley_vit_tpu/utils/logging.py`` the Shapley driver uses:
``get_logger`` builds a standard ``logging.Logger`` (file + stream);
``CSVLogger`` keeps the CSV experiment log (``party{rank}_{exp}_{mode}_log.csv``,
reference utils/logger.py:17) and a metrics CSV fed by
:meth:`CSVLogger.scalar_summary`.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
import time
from typing import Optional


def get_logger(
    name: str = "shapley_vit_tpu_torch",
    log_file: Optional[str] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """File+stream logger (reference utils.py:36-51 get_logger)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    have = {type(h).__name__ for h in logger.handlers}
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    if "StreamHandler" not in have:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
        for h in logger.handlers
    ):
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class CSVLogger:
    """CSV experiment log (reference utils/logger.py Logger).

    ``party{rank}_{exp_id}_{mode}_log.csv`` under ``output_dir``; ``log``
    writes a list as one row, ``print`` writes a message row, and
    ``scalar_summary(tag, value, step)`` appends to a metrics CSV."""

    def __init__(self, output_dir: str, dist_rank: int = 0, exp_id: str = "default",
                 mode: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(
            output_dir, f"party{dist_rank}_{exp_id}_{mode}_log.csv"
        )
        self.metrics_path = os.path.join(
            output_dir, f"party{dist_rank}_{exp_id}_{mode}_metrics.csv"
        )
        self._f = open(self.path, "a", newline="")
        self._writer = csv.writer(self._f)
        self._mf = None
        self._mwriter = None

    def log(self, row) -> None:
        self._writer.writerow(list(row))
        self._f.flush()

    def print(self, msg: str) -> None:
        self._writer.writerow([time.strftime("%Y-%m-%d %H:%M:%S"), msg])
        self._f.flush()

    def write(self, msg: str) -> None:
        self.print(msg)

    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        if self._mwriter is None:
            new = not os.path.exists(self.metrics_path)
            self._mf = open(self.metrics_path, "a", newline="")
            self._mwriter = csv.writer(self._mf)
            if new:
                self._mwriter.writerow(["step", "tag", "value", "wall_time"])
        self._mwriter.writerow([step, tag, value, time.time()])
        self._mf.flush()

    def close(self) -> None:
        self._f.close()
        if self._mf is not None:
            self._mf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
