"""Evaluation metrics, the port of ``pcmseg_tpu/ops/metrics.py`` as the eval
step uses them (``train/steps.py:392-400``): per sample, over flattened
binary masks, Dice = 2·∩ / (Σp + Σt + EPS) and IoU = ∩ / (Σp + Σt − ∩ +
EPS), EPS in the denominator only (the reference validator's formulas). For
K-class label maps, the same per foreground class 1..K−1
(``steps.py:366-378``). Where a rank holds one D-slab of each sample
(``collectives.spatial``), the per-sample sums go over the slabs before
the ratios.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcmseg_tpu_torch.parallel.collectives import spatial_sum

EPS = 1e-8


def per_sample_dice_iou(
    pred: torch.Tensor, target: torch.Tensor, eps: float = EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, ...) binary masks → ((N,) Dice, (N,) IoU), fp32 sums per sample."""
    n = pred.shape[0]
    p = pred.reshape(n, -1).float()
    t = target.reshape(n, -1).float()
    inter, psum, tsum = spatial_sum(torch.stack([(p * t).sum(1), p.sum(1), t.sum(1)]))
    return (2.0 * inter) / (psum + tsum + eps), inter / (psum + tsum - inter + eps)


def per_class_dice_iou(
    pred: torch.Tensor, target: torch.Tensor, n_classes: int, eps: float = EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, ...) integer label maps → ((N, K−1) Dice, (N, K−1) IoU) of the
    foreground classes 1..K−1, each class scored as a binary mask."""
    n = pred.shape[0]
    p = pred.reshape(n, -1).long()
    t = target.reshape(n, -1).long()
    scores = [per_sample_dice_iou(p == c, t == c, eps) for c in range(1, n_classes)]
    return torch.stack([d for d, _ in scores], 1), torch.stack([i for _, i in scores], 1)
