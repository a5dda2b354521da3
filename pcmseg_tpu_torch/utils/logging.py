"""Structured logging + step timing / throughput counters.

Replaces the reference's print()+tqdm surface (utils/trainer.py:177-195)
with a stdlib logger plus a throughput meter (volumes/sec is this repo's
north-star metric, BASELINE.json).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional


def get_logger(name: str = "pcmseg", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class StepTimer:
    """Tracks step wall time and items/sec with warmup-step exclusion."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self._steps = 0
        self._items = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._steps += 1
        if self._steps > self.warmup_steps:
            self._elapsed += dt
            self._items += items

    @property
    def items_per_sec(self) -> float:
        return self._items / self._elapsed if self._elapsed > 0 else 0.0

    @property
    def mean_step_time(self) -> float:
        n = self._steps - self.warmup_steps
        return self._elapsed / n if n > 0 else 0.0
