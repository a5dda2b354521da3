"""Overlap-tiled sliding-window inference, on the device.

The port of ``pcmseg_tpu/infer/sliding_window.py``: fixed-size windows at
static start offsets (the last one right-aligned) slide over the volume;
each tile's probabilities are weighted by a Gaussian centred in the window
(σ = window/8, floored at 1e-4·max) and blended over the coverage map.
Tiles go through the network ``tile_batch`` at a time; the last group is
padded with repeats of the first start, which are skipped when scattering.
Accumulation runs in place on the device, so the caller fetches one
tensor. A spatially sharded Predictor passes its sharded forward as the
network: each tile batch is split along D over the shards
(``predict.py:595-615``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLEND_MODES = ("gaussian", "uniform")


def _window_starts(size: int, window: int, stride: int) -> List[int]:
    """Start offsets covering [0, size) with the last window right-aligned."""
    if size <= window:
        return [0]
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return starts


def _tile_weight(window_size: Sequence[int], blend: str) -> np.ndarray:
    """(wd, wh, ww, 1) float32 blending weight for one tile."""
    if blend not in BLEND_MODES:
        raise ValueError(f"blend must be one of {BLEND_MODES}, got {blend!r}")
    wd, wh, ww = (int(x) for x in window_size)
    if blend == "uniform":
        return np.ones((wd, wh, ww, 1), np.float32)
    axes = []
    for n in (wd, wh, ww):
        x = np.arange(n, dtype=np.float64)
        sigma = max(n / 8.0, 1.0)
        axes.append(np.exp(-0.5 * ((x - (n - 1) / 2.0) / sigma) ** 2))
    w = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    w = np.maximum(w, 1e-4 * w.max())
    return w[..., None].astype(np.float32)


def tile_starts(
    volume_shape: Tuple[int, int, int], window_size: Sequence[int], overlap: float
) -> List[Tuple[int, int, int]]:
    """Every tile's (z0, y0, x0) over a volume padded up to one window."""
    wd, wh, ww = (int(x) for x in window_size)
    d, h, w = (max(int(s), win) for s, win in zip(volume_shape, (wd, wh, ww)))
    strides = [max(1, int(round(x * (1.0 - overlap)))) for x in (wd, wh, ww)]
    return [
        (z0, y0, x0)
        for z0 in _window_starts(d, wd, strides[0])
        for y0 in _window_starts(h, wh, strides[1])
        for x0 in _window_starts(w, ww, strides[2])
    ]


def make_sliding_window(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    volume_shape: Tuple[int, int, int],
    n_channels: int,
    n_out: int,
    window_size: Sequence[int] = (128, 128, 128),
    overlap: float = 0.5,
    blend: str = "gaussian",
    tile_batch: int = 1,
    *,
    device,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``run(image) -> (D, H, W, n_out)`` fp32 probabilities on ``device``.

    ``apply_fn`` maps a (B, wd, wh, ww, C) batch of tiles to
    (B, wd, wh, ww, n_out) probabilities. ``image`` is (D, H, W, C) on
    ``device``; it may be smaller than one window (it is zero-padded and
    the result cropped).
    ``device`` has no default: a caller that forgets it fails instead of
    tiling on the CPU.
    """
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    if tile_batch < 1:
        raise ValueError(f"tile_batch must be >= 1, got {tile_batch}")
    d, h, w = (int(s) for s in volume_shape)
    wd, wh, ww = (int(x) for x in window_size)
    pd, ph, pw = max(d, wd), max(h, wh), max(w, ww)
    starts = tile_starts((d, h, w), (wd, wh, ww), overlap)

    weight_np = _tile_weight((wd, wh, ww), blend)
    counts_np = np.zeros((pd, ph, pw, 1), dtype=np.float32)
    for z0, y0, x0 in starts:
        counts_np[z0 : z0 + wd, y0 : y0 + wh, x0 : x0 + ww] += weight_np
    weight = torch.from_numpy(weight_np).to(device)
    counts = torch.from_numpy(np.maximum(counts_np, 1e-8)).to(device)

    b = min(tile_batch, len(starts))
    padded_starts = [(s, True) for s in starts] + [(starts[0], False)] * ((-len(starts)) % b)
    groups = [padded_starts[i : i + b] for i in range(0, len(padded_starts), b)]

    def run(image: torch.Tensor) -> torch.Tensor:
        if tuple(image.shape) != (d, h, w, n_channels):
            raise ValueError(
                f"expected image {(d, h, w, n_channels)}, got {tuple(image.shape)}"
            )
        if (pd, ph, pw) != (d, h, w):
            image = F.pad(image, (0, 0, 0, pw - w, 0, ph - h, 0, pd - d))
        accum = torch.zeros((pd, ph, pw, n_out), dtype=torch.float32, device=image.device)
        for group in groups:
            tiles = torch.stack(
                [image[z0 : z0 + wd, y0 : y0 + wh, x0 : x0 + ww] for (z0, y0, x0), _ in group]
            )
            probs = apply_fn(tiles).float()
            for j, ((z0, y0, x0), real) in enumerate(group):
                if real:
                    accum[z0 : z0 + wd, y0 : y0 + wh, x0 : x0 + ww] += probs[j] * weight
        return (accum / counts)[:d, :h, :w]

    return run
