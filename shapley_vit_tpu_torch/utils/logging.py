"""Logging: one structured logger, the CSV experiment log and TensorBoard.

The parts of ``shapley_vit_tpu/utils/logging.py`` the drivers use:
``get_logger`` builds a standard ``logging.Logger`` (file + stream);
``CSVLogger`` keeps the CSV experiment log (``party{rank}_{exp}_{mode}_log.csv``,
reference utils/logger.py:17) and a metrics CSV fed by
:meth:`CSVLogger.scalar_summary`; ``TensorBoardWriter`` writes the
per-round scalars of ``--use-tensorboard`` and the Grad-CAM images through
the native event writer (``utils/tb_events.py``).
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


# Canonical utility-dimension names (reference start.py:88-91 utility_map);
# driver/report.py and the TB writer share this single mapping.
UTILITY_NAMES = {0: "accuracy", 1: "loss"}


class TensorBoardWriter:
    """Per-round TensorBoard scalars for the drivers (the reference ships a
    ``--use-tensorboard`` flag with no wired backend, opts.py:70-72):
    per-client SV (and ±σ) per utility dim, global utility, round wall time,
    eval counts, the per-phase spans and service-health values, keyed by
    epoch. Backed by the native event writer (``utils/tb_events.py``), not
    ``torch.utils.tensorboard``, which imports TensorFlow when present.
    Degrades to a no-op if the log dir is unwritable: observability is
    optional, the service is not."""

    def __init__(self, log_dir: str):
        self._w = None
        try:
            from shapley_vit_tpu_torch.utils.tb_events import ScalarEventWriter

            self._w = ScalarEventWriter(log_dir)
        except Exception as e:  # unwritable dir: observability is optional
            get_logger().info(f"tensorboard writer unavailable: {e}")

    @property
    def active(self) -> bool:
        return self._w is not None

    def log_round(self, step, shapley_value, se=None, utility=None,
                  wall_s=None, evals=None, phases=None,
                  health=None) -> None:
        if self._w is None:
            return
        for dim, sv in enumerate(shapley_value):
            name = UTILITY_NAMES.get(dim, str(dim))
            for cid, v in sv.items():
                self._w.add_scalar(f"shapley/{name}/client_{cid}", v, step)
                if se is not None:
                    self._w.add_scalar(
                        f"shapley_se/{name}/client_{cid}", se[dim][cid], step
                    )
            # cross-client SV distribution per round (a HistogramProto)
            if len(sv) > 1:
                self._w.add_histogram(
                    f"shapley/{name}/distribution", list(sv.values()), step,
                    bins=min(30, max(2, len(sv))),
                )
        if utility is not None:
            for dim, u in enumerate(utility):
                name = UTILITY_NAMES.get(dim, str(dim))
                self._w.add_scalar(f"global/{name}", u, step)
        if wall_s is not None:
            self._w.add_scalar("round/wall_s", wall_s, step)
        if evals is not None:
            self._w.add_scalar("round/coalition_evals", evals, step)
        for span, total in (phases or {}).items():
            self._w.add_scalar(f"round/phase_s/{span}", total, step)
        for name, v in (health or {}).items():
            self._w.add_scalar(f"health/{name}", v, step)
        self._w.flush()

    def add_image(self, tag: str, img, step: int) -> None:
        """uint8 or [0,1]-float HW / HW1 / HW3 / HW4 image -> Summary.Image
        (stdlib PNG; the backend for the reference's dead image_summary,
        logger.py:34-54)."""
        if self._w is not None:
            self._w.add_image(tag, img, step)
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
