"""Evaluation metrics, the port of ``pcmseg_tpu/ops/metrics.py`` as the eval
step uses them (``train/steps.py:392-400``): per sample, over flattened
binary masks, Dice = 2·∩ / (Σp + Σt + EPS) and IoU = ∩ / (Σp + Σt − ∩ +
EPS), EPS in the denominator only (the reference validator's formulas).
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-8


def per_sample_dice_iou(
    pred: torch.Tensor, target: torch.Tensor, eps: float = EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, ...) binary masks → ((N,) Dice, (N,) IoU), fp32 sums per sample."""
    n = pred.shape[0]
    p = pred.reshape(n, -1).float()
    t = target.reshape(n, -1).float()
    inter = (p * t).sum(1)
    psum, tsum = p.sum(1), t.sum(1)
    return (2.0 * inter) / (psum + tsum + eps), inter / (psum + tsum - inter + eps)
