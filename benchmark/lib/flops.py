"""Operations and bytes of the 3-D U-Net's layers, counted from their shapes.

Every count is of what the algorithm needs: each input byte read once and
each output byte written once, whatever a kernel reads again; the first
conv's 5 input channels are 5, not the 8 a kernel may pad them to. A
multiply-add is two operations."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from benchmark.lib import peaks


@dataclass(frozen=True)
class Conv:
    """One 3³ SAME conv of ``ci`` → ``co`` channels over ``voxels`` voxels of one sample."""

    ci: int
    co: int
    voxels: int

    @property
    def flop(self) -> int:
        return 2 * 27 * self.ci * self.co * self.voxels


def unet_levels(size: Tuple[int, int, int]) -> List[int]:
    """Voxels of one sample at each of the five U-Net levels."""
    d, h, w = size
    return [(d >> k) * (h >> k) * (w >> k) for k in range(5)]


def convs(base: int, n_modalities: int, size: Tuple[int, int, int]) -> List[Conv]:
    """The 18 3³ convs of a forward, in the model's order (encoder, then decoder)."""
    v = unet_levels(size)
    f = [base << k for k in range(5)]
    out = [Conv(n_modalities, f[0], v[0]), Conv(f[0], f[0], v[0])]
    for k in range(1, 5):
        out += [Conv(f[k - 1], f[k], v[k]), Conv(f[k], f[k], v[k])]
    for k in range(3, -1, -1):  # up1 .. up4: concat [skip, up] = 2·f[k] channels in
        out += [Conv(2 * f[k], f[k], v[k]), Conv(f[k], f[k], v[k])]
    return out


def forward_flop(base: int, n_modalities: int, n_classes: int, size: Tuple[int, int, int]) -> int:
    """Operations of one sample's forward: the 3³ convs, the four 2³ stride-2
    transposed convs and the 1×1×1 head (norms and activations not counted)."""
    v = unet_levels(size)
    f = [base << k for k in range(5)]
    total = sum(c.flop for c in convs(base, n_modalities, size))
    for k in range(4):  # up from level k+1 to level k: each input voxel makes 8 outputs
        total += 2 * v[k + 1] * f[k + 1] * f[k] * 8
    total += 2 * v[0] * f[0] * n_classes
    return total


def train_flop(base: int, n_modalities: int, n_classes: int, size, samples: int) -> int:
    """Operations of a training step over ``samples`` samples: the backward
    counted as twice the forward."""
    return 3 * samples * forward_flop(base, n_modalities, n_classes, size)


def conv_seconds(c: Conv, kind: str) -> float:
    """The least time one H100 needs for one 16-bit conv call: the larger of
    its operations at the tensor cores' peak and its bytes at HBM's.
    ``kind``: 'fwd' (reads x, the 16-bit weight and fp32 bias, writes y),
    'dx' (reads dy and the weight, writes dx) or 'dw' (reads x and dy,
    writes the fp32 (27, Ci, Co) gradient)."""
    act = 2 * c.voxels * (c.ci + c.co)
    if kind == "fwd":
        moved = act + 2 * 27 * c.ci * c.co + 4 * c.co
    elif kind == "dx":
        moved = act + 2 * 27 * c.ci * c.co
    elif kind == "dw":
        moved = act + 4 * 27 * c.ci * c.co
    else:
        raise ValueError(f"unknown conv call kind {kind!r}")
    return max(c.flop / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_S)


def forward_bound(base: int, n_modalities: int, size) -> float:
    """Least seconds of the 18 forward conv calls of one sample."""
    return sum(conv_seconds(c, "fwd") for c in convs(base, n_modalities, size))


def dx_bound(base: int, n_modalities: int, size) -> float:
    """Least seconds of the 17 dx calls of one sample (the first conv's input needs none)."""
    return sum(conv_seconds(c, "dx") for c in convs(base, n_modalities, size)[1:])


def dw_bound(base: int, n_modalities: int, size) -> float:
    """Least seconds of the 18 weight-gradient calls of one sample."""
    return sum(conv_seconds(c, "dw") for c in convs(base, n_modalities, size))


def share(bound_s: float, measured_s: float) -> float:
    """A roofline or peak share in percent."""
    if measured_s <= 0:
        raise ValueError(f"measured {measured_s} s")
    return 100.0 * bound_s / measured_s
