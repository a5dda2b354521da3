"""Host-side training control: LR schedules and early stopping.

A copy of ``pcmseg_tpu/train/schedule.py`` (pure Python), because that
module cannot be imported without JAX: ``pcmseg_tpu/train/__init__.py``
imports the JAX train steps. Same classes, rules and ``state_dict`` /
``load_state_dict`` surface, so a resume restores them exactly:

  * ``ReduceLROnPlateau``: torch's rule with the reference's settings
    (mode 'min', factor 0.5, patience 10, relative threshold 1e-4);
  * ``EpochSchedule``: cosine, poly ``(1 - t)^0.9`` and constant, with an
    optional linear warmup;
  * ``WarmupPlateau``: linear warmup in front of the plateau rule;
  * ``EarlyStopping``: stop after ``patience`` epochs without improvement.

``make_scheduler`` picks one from ``config.scheduler``. The trainer sets the
optimizer's learning rate from ``lr`` before each epoch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0

    best: Optional[float] = None
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < self.best * (1.0 - self.threshold)
            return metric < self.best - self.threshold
        else:
            if self.threshold_mode == "rel":
                return metric > self.best * (1.0 + self.threshold)
            return metric > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    # -- (de)serialization for checkpoint resume -----------------------------
    def state_dict(self) -> Dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: Dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.cooldown_counter = d["cooldown_counter"]

    @classmethod
    def from_config(cls, config) -> "ReduceLROnPlateau":
        return cls(
            lr=config.learning_rate,
            mode=config.plateau_mode,
            factor=config.plateau_factor,
            patience=config.plateau_patience,
            threshold=config.plateau_threshold,
            cooldown=config.plateau_cooldown,
            min_lr=config.min_lr,
        )


@dataclass
class EpochSchedule:
    """Metric-independent per-epoch LR decay with optional linear warmup.

    ``lr`` is the rate for the epoch about to run; ``step(metric)`` is
    called after each epoch (the metric is ignored — uniform interface
    with ReduceLROnPlateau) and returns the next epoch's rate.

    Shapes (t = post-warmup progress in [0, 1]):
      * cosine:   min_lr + (base - min_lr) * (1 + cos(pi t)) / 2
      * poly:     min_lr + (base - min_lr) * (1 - t)^power
      * constant: base
    Warmup epochs ramp linearly: base * (e + 1) / warmup_epochs.
    """

    kind: str  # 'cosine' | 'poly' | 'constant'
    base_lr: float
    total_epochs: int
    warmup_epochs: int = 0
    min_lr: float = 0.0
    poly_power: float = 0.9

    epochs_done: int = 0

    @property
    def lr(self) -> float:
        return self.lr_at(self.epochs_done)

    def lr_at(self, epoch: int) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            return self.base_lr * (epoch + 1) / self.warmup_epochs
        if self.kind == "constant":
            return self.base_lr
        span = max(1, self.total_epochs - self.warmup_epochs)
        t = min(max(epoch - self.warmup_epochs, 0) / span, 1.0)
        if self.kind == "cosine":
            return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
                1.0 + math.cos(math.pi * t)
            )
        return self.min_lr + (self.base_lr - self.min_lr) * (1.0 - t) ** (
            self.poly_power
        )

    def step(self, metric: float) -> float:
        del metric
        self.epochs_done += 1
        return self.lr

    def state_dict(self) -> Dict:
        return {"epochs_done": self.epochs_done}

    def load_state_dict(self, d: Dict) -> None:
        self.epochs_done = d["epochs_done"]


@dataclass
class WarmupPlateau:
    """Linear warmup in front of ReduceLROnPlateau.

    During warmup the LR ramps and epoch metrics do NOT count against the
    plateau's patience (a ramping LR makes them incomparable); from the
    first post-warmup epoch the inner torch-exact plateau takes over.
    """

    inner: ReduceLROnPlateau
    base_lr: float
    warmup_epochs: int
    epochs_done: int = 0

    @property
    def lr(self) -> float:
        if self.epochs_done < self.warmup_epochs:
            return self.base_lr * (self.epochs_done + 1) / self.warmup_epochs
        return self.inner.lr

    def step(self, metric: float) -> float:
        self.epochs_done += 1
        if self.epochs_done <= self.warmup_epochs:
            return self.lr
        return self.inner.step(metric)

    def state_dict(self) -> Dict:
        return {"epochs_done": self.epochs_done, "inner": self.inner.state_dict()}

    def load_state_dict(self, d: Dict) -> None:
        self.epochs_done = d["epochs_done"]
        self.inner.load_state_dict(d["inner"])


def make_scheduler(config):
    """Build the configured LR schedule (config.scheduler).

    All returned objects share lr/step/state_dict/load_state_dict, start
    at the epoch-0 rate (which under warmup is NOT config.learning_rate —
    the Trainer installs scheduler.lr before the first epoch).
    """
    if config.scheduler == "reduce_on_plateau":
        plateau = ReduceLROnPlateau.from_config(config)
        if config.warmup_epochs > 0:
            return WarmupPlateau(
                inner=plateau,
                base_lr=config.learning_rate,
                warmup_epochs=config.warmup_epochs,
            )
        return plateau
    return EpochSchedule(
        kind=config.scheduler,
        base_lr=config.learning_rate,
        total_epochs=config.num_epochs,
        warmup_epochs=config.warmup_epochs,
        min_lr=config.min_lr,
        poly_power=config.poly_power,
    )


@dataclass
class EarlyStopping:
    patience: int = 15
    mode: str = "min"
    min_delta: float = 0.0

    best: Optional[float] = None
    num_bad_epochs: int = 0
    should_stop: bool = False

    def step(self, metric: float) -> bool:
        """Record an epoch metric; returns True when training should stop."""
        improved = self.best is None or (
            metric < self.best - self.min_delta
            if self.mode == "min"
            else metric > self.best + self.min_delta
        )
        if improved:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        self.should_stop = self.num_bad_epochs >= self.patience
        return self.should_stop

    def state_dict(self) -> Dict:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "should_stop": self.should_stop,
        }

    def load_state_dict(self, d: Dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.should_stop = d["should_stop"]
