"""Deterministic K-fold splitting over the *filtered* case list.

The port's copy of ``pcmseg_tpu/data/kfold.py``.

The reference computed folds over the raw ADC-directory scan while the
dataset dropped invalid cases, letting Subset indices drift out of range
(SURVEY.md §8.6, data_loader.py:484-497). Here splits are computed over the
dataset's post-filter length, with sklearn's KFold(shuffle=True,
random_state=seed) for split-for-split compatibility with the reference's
sklearn call (data_loader.py:490-494, seed 42).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES
from pcmseg_tpu_torch.data.dataset import ProstateDataset


def kfold_indices(
    n_cases: int, n_splits: int = 5, seed: int = 42, shuffle: bool = True
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, val_idx) per fold, sklearn-KFold-compatible."""
    if n_splits < 2:
        raise ValueError(f"n_splits must be >= 2, got {n_splits}")
    if n_cases < n_splits:
        raise ValueError(
            f"cannot split {n_cases} cases into {n_splits} folds"
        )
    try:
        from sklearn.model_selection import KFold

        kf = KFold(n_splits=n_splits, shuffle=shuffle, random_state=seed)
        return [(tr.copy(), va.copy()) for tr, va in kf.split(np.arange(n_cases))]
    except ImportError:
        # sklearn-equivalent fallback: shuffled permutation, first
        # n % k folds get one extra element
        idx = np.arange(n_cases)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        sizes = np.full(n_splits, n_cases // n_splits)
        sizes[: n_cases % n_splits] += 1
        folds, start = [], 0
        for s in sizes:
            folds.append(idx[start : start + s])
            start += s
        return [
            (np.sort(np.concatenate(folds[:i] + folds[i + 1 :])), np.sort(folds[i]))
            for i in range(n_splits)
        ]


def get_kfold_splits(
    data_dir: str,
    n_splits: int = 5,
    seed: int = 42,
    data_type: str = "BPH",
    modalities: Sequence[str] = DEFAULT_MODALITIES,
    missing_strategy: str = "zero_fill",
    dataset: Optional[ProstateDataset] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Folds over the filtered case list (same API shape as the reference's
    get_kfold_splits, data_loader.py:468-497, but indices are guaranteed
    valid for the dataset that will consume them)."""
    if dataset is None:
        dataset = ProstateDataset(
            data_dir=data_dir,
            data_type=data_type,
            modalities=modalities,
            missing_strategy=missing_strategy,
        )
    return kfold_indices(len(dataset), n_splits=n_splits, seed=seed)
