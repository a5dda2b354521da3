"""Single-split trainer on one GPU, the port of ``pcmseg_tpu/train/trainer.py``.

The streamed path of the JAX trainer:

  * the split: ``val_fraction`` of the cases, drawn with
    ``default_rng(seed).permutation`` (``trainer.py:88-106``);
  * every batch, the ragged tail included, padded to ``batch_size``
    rounded up to ``accum_steps`` (``trainer.py:127-136`` at one device);
  * ``train_epoch``: batches decoded by the loader's threads, prefetched to
    the card from pinned memory, each step's loss fetched after the next
    step is queued, and a non-finite loss aborts the epoch
    (``trainer.py:565-598, 670-708``);
  * ``validate_epoch``: loss and weighted Dice/IoU (``trainer.py:710-780``);
  * the epoch loop (``trainer.py:792-852``): the schedule sets the LR, early
    stopping on the monitored loss, ``latest`` every epoch, ``best`` on
    improvement (also written as a reference-layout ``best.pth`` that
    ``predict`` and ``serve`` take as it is), ``epoch_{e}`` every
    ``save_frequency`` epochs, pruned to ``keep_checkpoints``;
  * real resume from ``latest`` (``trainer.py:480-508``), loaders included.

Options of the JAX trainer that are not ported raise ``NotImplementedError``
naming the option. The device data cache (on by default) is not ported:
every epoch streams, and the trainer says so once.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pcmseg_tpu_torch.core.config import Config
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.data.loader import DataLoader, prefetch_to_device
from pcmseg_tpu_torch.infer.predict import resolve_device
from pcmseg_tpu_torch.models.unet3d import DTYPES, UNet3D
from pcmseg_tpu_torch.train.checkpoints import (
    copy_train_checkpoint,
    load_train_checkpoint,
    prune_periodic,
    save_pth,
    save_train_checkpoint,
    train_checkpoint_path,
)
from pcmseg_tpu_torch.train.schedule import EarlyStopping, make_scheduler
from pcmseg_tpu_torch.utils.logging import StepTimer, get_logger
from pcmseg_tpu_torch.train.steps import (
    create_train_state,
    make_eval_step,
    make_train_step,
    refuse_unported_training,
    set_learning_rate,
)


class Trainer:
    """Config-driven trainer over one train(/val) split on ``device``
    (default: the current CUDA device; without one, pass ``device="cpu"``)."""

    def __init__(self, config: Config, device=None):
        refuse_unported_training(config)
        self.config = config
        self.log = get_logger("pcmseg.trainer")
        self.device = resolve_device(device)
        self.dtype = DTYPES[config.compute_dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"compute_dtype={config.compute_dtype!r} on CUDA: the conv kernels compute in bfloat16"
            )
        if config.device_data_cache_gb > 0:
            self.log.info(
                "device_data_cache_gb=%s: the device data cache is not ported; every epoch "
                "streams from the host", config.device_data_cache_gb,
            )

        self.dataset = ProstateDataset(
            data_dir=config.data_dir,
            data_type=config.data_type,
            modalities=config.modalities,
            missing_strategy=config.missing_strategy,
            target_size=config.target_size,
            normalize=config.normalize,
            norm_percentiles=config.norm_percentiles,
            cache_dir=config.cache_dir,
            n_classes=config.n_classes,
            coregister=config.coregister,
        )
        n = len(self.dataset)
        if n == 0:
            raise RuntimeError(
                f"no valid cases found under {config.data_dir!r} (data_type={config.data_type})"
            )

        # -- split ----------------------------------------------------------
        self.train_indices: List[int] = list(range(n))
        self.val_indices: Optional[List[int]] = None
        if config.validation and n >= 2:
            perm = np.random.default_rng(config.seed).permutation(n)
            n_val = max(1, int(round(n * config.val_fraction)))
            self.val_indices = np.sort(perm[:n_val]).tolist()
            self.train_indices = np.sort(perm[n_val:]).tolist()

        # every batch pads to one size, divisible by the accumulation steps
        accum = max(1, int(config.accum_steps))
        self._pad_to = -(-config.batch_size // accum) * accum

        augmenter = None
        if config.data_augmentation or config.train_crop:
            from pcmseg_tpu_torch.data.augment import Augmenter

            aug_on = config.data_augmentation
            augmenter = Augmenter(
                seed=config.seed,
                flip=aug_on and config.aug_flip,
                rot90=aug_on and config.aug_rot90,
                intensity_jitter=config.aug_intensity_jitter if aug_on else 0.0,
                crop=config.train_crop,
                oversample_fg=config.oversample_fg,
                oversample_mode=config.oversample_mode,
                scale=config.aug_scale if aug_on else 0.0,
                rotate_deg=config.aug_rotate_deg if aug_on else 0.0,
                gamma=config.aug_gamma if aug_on else 0.0,
                noise=config.aug_noise if aug_on else 0.0,
                blur_prob=config.aug_blur_prob if aug_on else 0.0,
            )
        self.train_loader = DataLoader(
            self.dataset, batch_size=config.batch_size, shuffle=True,
            indices=self.train_indices, seed=config.seed, augmenter=augmenter,
            pad_to=self._pad_to,
        )
        self.val_loader = (
            DataLoader(
                self.dataset, batch_size=config.batch_size, shuffle=False,
                indices=self.val_indices, pad_to=self._pad_to,
            )
            if self.val_indices
            else None
        )

        # -- model / state ----------------------------------------------------
        model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(config.seed))
        self.state = create_train_state(model.to(self.device), config)
        self._train_step = make_train_step(model, config)
        self._eval_step = make_eval_step(model, config)

        self.scheduler = make_scheduler(config)
        self.early_stopping = EarlyStopping(patience=config.patience)
        self.history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        self.best_monitor = float("inf")
        self.start_epoch = 0
        self.timer = StepTimer(warmup_steps=1)
        if config.resume:
            self._try_resume()

    # -- checkpoints -------------------------------------------------------------

    def _meta(self, epoch: int, monitor: float) -> dict:
        return {
            "epoch": epoch,
            "monitor": monitor,
            "best_monitor": self.best_monitor,
            "history": self.history,
            "scheduler": self.scheduler.state_dict(),
            "early_stopping": self.early_stopping.state_dict(),
            "config": self.config.to_dict(),
        }

    def _serving_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights that validation scores: the EMA when it is on."""
        sd = self.state.model.state_dict()
        if self.state.ema is not None and self.config.ema_eval:
            sd.update(self.state.ema)
        return sd

    def _save_epoch(self, epoch: int, monitor: float, is_best: bool) -> None:
        cfg = self.config
        meta = self._meta(epoch, monitor)
        # one serialization per epoch; 'best' and 'epoch_{e}' are file copies
        save_train_checkpoint(cfg.save_dir, "latest", self.state, meta)
        if is_best:
            copy_train_checkpoint(cfg.save_dir, "latest", "best")
            save_pth(os.path.join(cfg.save_dir, "best.pth"), self._serving_state_dict(), cfg.to_dict())
        if cfg.save_frequency and (epoch + 1) % cfg.save_frequency == 0:
            copy_train_checkpoint(cfg.save_dir, "latest", f"epoch_{epoch + 1}")
            prune_periodic(cfg.save_dir, cfg.keep_checkpoints)

    def _try_resume(self) -> None:
        path = train_checkpoint_path(self.config.save_dir, "latest")
        if not os.path.exists(path):
            self.log.info("resume requested but no latest checkpoint; fresh start")
            return
        meta = load_train_checkpoint(path, self.state)
        self.history = meta.get("history", self.history)
        self.best_monitor = meta.get("best_monitor", float("inf"))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        # the loaders' shuffle and augmentation streams are (seed, epoch)
        # derived: replay the order an uninterrupted run would use
        self.train_loader.set_epoch(self.start_epoch)
        if self.val_loader is not None:
            self.val_loader.set_epoch(self.start_epoch)
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
        if "early_stopping" in meta:
            self.early_stopping.load_state_dict(meta["early_stopping"])
        self.log.info("resumed from %s at epoch %d", path, self.start_epoch)

    # -- epochs ------------------------------------------------------------------

    def _device_batches(self, loader: DataLoader):
        def host_batches():
            for batch in loader:
                batch["n_real"] = float(np.sum(batch["weight"]))  # unpadded samples
                yield batch

        yield from prefetch_to_device(host_batches(), self.device, self.dtype, size=self.config.prefetch)

    def _consume_loss(self, step_idx: int, loss: torch.Tensor, losses: list, n_total: int) -> None:
        """Fetch a step's loss (one step late), abort on non-finite, log."""
        value = float(loss)
        if not math.isfinite(value):
            raise FloatingPointError(
                f"non-finite training loss ({value}) at batch {step_idx} — aborting instead "
                "of training on"
            )
        losses.append(value)
        cfg = self.config
        if cfg.log_frequency and step_idx % max(cfg.log_frequency, 1) == 0:
            self.log.debug("batch %d: loss %.4f", step_idx, value)
        if cfg.print_frequency and (step_idx + 1) % max(cfg.print_frequency, 1) == 0:
            self.log.info(
                "batch %d/%s: loss %.4f (%.2f vol/s)",
                step_idx + 1, n_total or "?", value, self.timer.items_per_sec,
            )

    def train_epoch(self) -> float:
        losses: List[float] = []
        n_total = len(self.train_loader)
        pending = None  # (step_idx, loss) of the step in flight
        for step_idx, batch in enumerate(self._device_batches(self.train_loader)):
            self.timer.start()
            metrics = self._train_step(self.state, batch)
            if pending is not None:
                self._consume_loss(*pending, losses, n_total)
            pending = (step_idx, metrics["loss"])
            self.timer.stop(items=int(batch["n_real"]))
        if pending is not None:
            self._consume_loss(*pending, losses, n_total)
        return float(np.mean(losses)) if losses else float("nan")

    def validate_epoch(self) -> Dict[str, float]:
        fetched = []
        for batch in self._device_batches(self.val_loader):
            m = self._eval_step(self.state, batch)
            fetched.append({k: float(m[k]) for k in ("loss", "dice_sum", "iou_sum", "weight_sum")})
        w_sum = sum(m["weight_sum"] for m in fetched)
        return {
            "loss": float(np.mean([m["loss"] for m in fetched])) if fetched else float("nan"),
            "dice": sum(m["dice_sum"] for m in fetched) / max(w_sum, 1.0),
            "iou": sum(m["iou_sum"] for m in fetched) / max(w_sum, 1.0),
        }

    def train(self) -> Dict[str, List[float]]:
        cfg = self.config
        self.log.info(
            "training %d cases (val: %s) for %d epochs, batch %d on %s",
            len(self.train_indices), len(self.val_indices) if self.val_indices else 0,
            cfg.num_epochs, cfg.batch_size, self.device,
        )
        # the schedule's current rate, not config.learning_rate: under warmup
        # (or a resume mid-decay) the first epoch's LR differs
        set_learning_rate(self.state, self.scheduler.lr)
        for epoch in range(self.start_epoch, cfg.num_epochs):
            train_loss = self.train_epoch()
            self.history["train_loss"].append(train_loss)
            if self.val_loader is not None:
                val = self.validate_epoch()
                self.history["val_loss"].append(val["loss"])
                self.history.setdefault("val_dice", []).append(val["dice"])
                self.history.setdefault("val_iou", []).append(val["iou"])
                monitor = val["loss"]
                self.log.info(
                    "epoch %d: train %.4f val %.4f dice %.4f iou %.4f lr %.2e (%.2f vol/s)",
                    epoch, train_loss, val["loss"], val["dice"], val["iou"],
                    self.scheduler.lr, self.timer.items_per_sec,
                )
            else:
                monitor = train_loss
                self.log.info(
                    "epoch %d: train %.4f lr %.2e (%.2f vol/s)",
                    epoch, train_loss, self.scheduler.lr, self.timer.items_per_sec,
                )
            set_learning_rate(self.state, self.scheduler.step(monitor))
            # best_monitor moves before the latest save, so a resume from
            # latest(e) never re-awards 'best' to a worse later epoch
            is_best = monitor < self.best_monitor
            if is_best:
                self.best_monitor = monitor
            self._save_epoch(epoch, monitor, is_best)
            if cfg.early_stopping and self.early_stopping.step(monitor):
                self.log.info("early stopping at epoch %d", epoch)
                break
        return self.history
