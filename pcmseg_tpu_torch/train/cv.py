"""K-fold cross-validation trainer, the port of ``pcmseg_tpu/train/cv.py``.

Deterministic K-fold (``data/kfold.py``: sklearn's ``KFold(shuffle=True,
random_state=seed)``, or its equivalent without sklearn) over the *filtered*
case list; one dataset shared by every fold; a fresh model, optimizer and
schedule per fold (a fresh :class:`Trainer` tagged ``fold_{k}``, so its
checkpoints are ``latest_fold_{k}.pt``, ``best_fold_{k}.pt`` and the
reference-layout ``best_fold_{k}.pth`` that ``predict``, ``serve`` and
``validate`` take as a fold ensemble); per-fold ``fold_{k}_history.json``;
an aggregate ``cv_results.json`` with the mean and the sample std
(ddof=1) of the folds' best validation losses.

Under a process group every process runs every fold's Trainer in step
(each fold on the Trainer's data × spatial × model mesh); the primary alone writes
the JSON files, and every process meets it at a barrier after each, so a
resumed run reads the same completed folds on every process.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from pcmseg_tpu_torch.core.config import Config
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.data.kfold import kfold_indices
from pcmseg_tpu_torch.infer.predict import resolve_device
from pcmseg_tpu_torch.parallel import multihost
from pcmseg_tpu_torch.train.trainer import Trainer
from pcmseg_tpu_torch.utils.artifacts import write_json
from pcmseg_tpu_torch.utils.logging import get_logger


def _fold_result(fold_idx: int, history: Dict) -> Dict:
    return {
        "fold": fold_idx + 1,
        "best_val_loss": float(np.min(history["val_loss"])) if history.get("val_loss") else float("inf"),
        "epochs_trained": len(history["train_loss"]),
    }


class CrossValidationTrainer:
    """Runs ``config.n_splits`` folds on ``device``, each a fresh
    :class:`Trainer` (default device: the current CUDA device; without
    one, pass ``device="cpu"``)."""

    def __init__(self, config: Config, dataset: Optional[ProstateDataset] = None, device=None):
        self.config = config
        self.log = get_logger("pcmseg.cv")
        if not multihost.is_primary():
            self.log.setLevel("WARNING")
        self.device = resolve_device(device)
        self.dataset = dataset if dataset is not None else ProstateDataset(
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
        self.splits = kfold_indices(len(self.dataset), n_splits=config.n_splits, seed=config.seed)
        self.fold_results: List[Dict] = []

    def train_fold(self, fold_idx: int) -> Dict:
        tr_idx, va_idx = self.splits[fold_idx]
        self.log.info(
            "fold %d/%d: %d train / %d val cases",
            fold_idx + 1, len(self.splits), len(tr_idx), len(va_idx),
        )
        trainer = Trainer(
            self.config,
            dataset=self.dataset,
            train_indices=tr_idx.tolist(),
            val_indices=va_idx.tolist(),
            tag=f"fold_{fold_idx}",
            device=self.device,
        )
        history = trainer.train()
        self._write_json(f"fold_{fold_idx}_history.json", history)
        result = _fold_result(fold_idx, history)
        self.fold_results.append(result)
        return result

    def _completed_fold_result(self, fold_idx: int) -> Optional[Dict]:
        """A finished fold's result, from its history JSON.

        ``fold_{k}_history.json`` is written only after the fold's training
        loop returns, so it marks the fold complete. A fold killed
        mid-training has checkpoints but no history file; re-run under
        ``config.resume`` its Trainer picks up from ``latest_fold_{k}``.
        A history shorter than ``num_epochs`` with early stopping off means
        the run was extended: the fold is entered again and resumes.
        """
        path = os.path.join(self.config.save_dir, f"fold_{fold_idx}_history.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                history = json.load(f)
        except (OSError, ValueError):
            return None  # unreadable/truncated marker -> re-run the fold
        if not history.get("train_loss"):
            return None
        if len(history["train_loss"]) < self.config.num_epochs and not self.config.early_stopping:
            return None
        return _fold_result(fold_idx, history)

    def train(self) -> Dict:
        for k in range(len(self.splits)):
            if self.config.resume:
                done = self._completed_fold_result(k)
                if done is not None:
                    self.log.info(
                        "fold %d/%d already complete (%d epochs); skipping",
                        k + 1, len(self.splits), done["epochs_trained"],
                    )
                    self.fold_results.append(done)
                    continue
            self.train_fold(k)
        results = self.save_results()
        self.print_summary()
        return results

    def save_results(self) -> Dict:
        losses = [r["best_val_loss"] for r in self.fold_results]
        results = {
            "config": self.config.to_dict(),
            "fold_results": self.fold_results,
            "summary": {
                "mean_val_loss": float(np.mean(losses)),
                # the sample std (torch's .std(), train_bph_optimized.py:450)
                "std_val_loss": float(np.std(losses, ddof=1)) if len(losses) > 1 else 0.0,
                "total_folds": len(self.fold_results),
            },
        }
        path = self._write_json("cv_results.json", results)
        self.log.info("cross-validation results written to %s", path)
        return results

    def _write_json(self, name: str, payload) -> str:
        """``save_dir/name``, written by the primary process; every process
        waits until it is there."""
        path = os.path.join(self.config.save_dir, name)
        if multihost.is_primary():
            write_json(path, payload)
        multihost.barrier(multihost.next_tag(f"cv/{name}"))
        return path

    def print_summary(self) -> None:
        for r in self.fold_results:
            self.log.info(
                "fold %d: best val loss %.4f (%d epochs)",
                r["fold"], r["best_val_loss"], r["epochs_trained"],
            )
        losses = [r["best_val_loss"] for r in self.fold_results]
        if losses:
            self.log.info(
                "mean val loss: %.4f +- %.4f",
                float(np.mean(losses)),
                float(np.std(losses, ddof=1)) if len(losses) > 1 else 0.0,
            )
