"""Operations and least times of nnU-Net's PlainConvUNet (3d_fullres), counted
from its layer shapes as ``flops.py`` counts the U-Net's: each 3³ conv at its
real channel counts (Ci = 32 is 32, not the 64 a kernel pads it to), a
multiply-add two operations, the backward twice the forward."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from benchmark.lib import flops


def levels(size: Sequence[int], stages: int) -> List[int]:
    """Voxels of one sample at each stage's resolution (stride 2 a stage)."""
    d, h, w = size
    return [(d >> k) * (h >> k) * (w >> k) for k in range(stages)]


def convs(features: Sequence[int], n_modalities: int, size: Sequence[int]) -> List[Tuple[flops.Conv, int]]:
    """Every 3³ conv of a forward with its stride, in the model's order
    (encoder stages, then decoder stages from the lowest resolution); a
    strided conv's ``voxels`` are its output's."""
    v = levels(size, len(features))
    out = []
    for s, co in enumerate(features):
        ci = n_modalities if s == 0 else features[s - 1]
        out += [(flops.Conv(ci, co, v[s]), 1 if s == 0 else 2), (flops.Conv(co, co, v[s]), 1)]
    for s in range(len(features) - 2, -1, -1):  # decoder: cat([up, skip]) = 2·features[s] in
        out += [(flops.Conv(2 * features[s], features[s], v[s]), 1), (flops.Conv(features[s], features[s], v[s]), 1)]
    return out


def b1_convs(features: Sequence[int], n_modalities: int, size: Sequence[int]) -> List[flops.Conv]:
    """The stride-1 convs, which B1 computes forward and B2 differentiates."""
    return [c for c, stride in convs(features, n_modalities, size) if stride == 1]


def head_stages(stages: int) -> List[int]:
    """The resolutions (as powers of 1/2) of the heads a training forward
    computes: the full one and those at 1/2, 1/4 and 1/8 above the lowest
    decoder stage's."""
    return [0] + [k for k in (1, 2, 3) if k < stages - 2]


def forward_flop(features: Sequence[int], n_modalities: int, n_classes: int, size: Sequence[int]) -> int:
    """Operations of one sample's training forward: every 3³ conv, strided
    or not, the 2³ stride-2 transposed convs and the 1×1×1 heads it computes
    (norms and activations not counted)."""
    v = levels(size, len(features))
    total = sum(c.flop for c, _ in convs(features, n_modalities, size))
    for s in range(len(features) - 1):  # up from stage s+1 to s: each input voxel makes 8 outputs
        total += 2 * v[s + 1] * features[s + 1] * features[s] * 8
    total += sum(2 * v[k] * features[k] * n_classes for k in head_stages(len(features)))
    return total


def train_flop(features, n_modalities: int, n_classes: int, size, samples: int) -> int:
    """Operations of a training step over ``samples`` samples."""
    return 3 * samples * forward_flop(features, n_modalities, n_classes, size)


def b1_bound_s(features, n_modalities: int, size) -> float:
    """Least seconds of one sample's B1 calls: the forward of every stride-1
    conv and the dx of each but the first (its input is the image)."""
    cs = b1_convs(features, n_modalities, size)
    return sum(flops.conv_seconds(c, "fwd") for c in cs) + sum(flops.conv_seconds(c, "dx") for c in cs[1:])


def b2_bound_s(features, n_modalities: int, size) -> float:
    """Least seconds of one sample's B2 calls (the stride-1 convs' dW)."""
    return sum(flops.conv_seconds(c, "dw") for c in b1_convs(features, n_modalities, size))
