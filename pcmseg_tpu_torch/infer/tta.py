"""Test-time augmentation: axis-flip ensembling for segmentation serving.

The port of ``pcmseg_tpu/infer/tta.py``: predict under all 2³ = 8
combinations of D/H/W flips, un-flip each probability map, and average in
probability space, summing in the JAX package's order. Flips are the only
augmentations that are exactly invertible on the voxel grid. The wrapper
takes the place of the apply function wherever it is used, so it wraps the
fold ensemble and composes with sliding-window tiling (each tile batch is
ensembled in place): 8 forwards per apply, each one a forward through the
hand-written conv kernel on a CUDA tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

# all 2^3 combinations of flipping the spatial axes of (N, D, H, W, C)
FLIP_SETS = tuple(
    tuple(ax for ax, on in zip((1, 2, 3), (fd, fh, fw)) if on)
    for fd in (False, True)
    for fh in (False, True)
    for fw in (False, True)
)


def make_tta_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap ``apply_fn(x) -> probs``, (N, D, H, W, C) → (N, D, H, W, K)
    probabilities, with the flip ensemble."""

    def tta(x: torch.Tensor) -> torch.Tensor:
        acc = None
        for axes in FLIP_SETS:
            p = apply_fn(torch.flip(x, axes) if axes else x)
            p = torch.flip(p, axes) if axes else p
            acc = p if acc is None else acc + p
        return acc / float(len(FLIP_SETS))

    return tta
