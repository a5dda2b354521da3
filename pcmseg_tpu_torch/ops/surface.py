"""Surface-distance metrics: robust Hausdorff (HD95), ASSD, surface Dice.

The port's copy of ``pcmseg_tpu/ops/surface.py``.

Beyond-reference evaluation. The reference validator scores overlap only
(Dice/IoU — reference script/validate_model.py:24-95), which is blind to
boundary error: a mask that over-segments by one voxel everywhere and one
that hallucinates a distant island can score the same Dice. Clinical
segmentation evaluation therefore also reports boundary metrics; these are
the three standard ones:

* ``hausdorff_distance(percentile=95)`` — the robust (percentile) Hausdorff:
  max over both directions of the p-th percentile of surface-to-surface
  distances. Insensitive to single outlier voxels at p<100.
* ``assd`` — average symmetric surface distance: mean over the union of
  both directed distance sets.
* ``surface_dice(tolerance)`` — normalized surface Dice (NSD): the fraction
  of surface points whose nearest point on the other surface lies within
  ``tolerance`` (physical units).

Design: host-side numpy/scipy ON PURPOSE. These metrics are sparse,
data-dependent gathers over irregular surface point sets — a poor fit for
the tensor cores and static shapes — and they consume masks the validator
has already fetched to the host (uint8, 2 MB per 128³ case). Computing them
on CPU overlaps with the device working the next batch; an on-device EDT
would serialize against it for no FLOP advantage.

Distances are measured between surface-voxel centers via two Euclidean
distance transforms (one per direction), the same discretization used by
the standard evaluation packages in this domain. ``spacing`` is the voxel
size along each DATA axis (so pass mm spacing for native-grid volumes and
leave it at 1.0 for resampled grids — distances then read in voxels).

Empty-mask conventions (both masks empty / exactly one empty):
* distances (HD, ASSD): 0.0 / ``inf``
* surface_dice: 1.0 / 0.0
Callers writing JSON should map non-finite values to ``null``
(see infer/validate.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _as_bool(mask: np.ndarray) -> np.ndarray:
    mask = np.asarray(mask)
    if mask.ndim == 4 and mask.shape[-1] == 1:  # (D,H,W,1) channel dim
        mask = mask[..., 0]
    if mask.ndim != 3:
        raise ValueError(f"expected a 3-D mask, got shape {mask.shape}")
    return mask.astype(bool)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boolean surface of a solid mask: voxels removed by one 6-connected
    erosion (border voxels count — the volume edge is a boundary)."""
    from scipy import ndimage

    if not mask.any():
        return mask
    struct = ndimage.generate_binary_structure(3, 1)
    eroded = ndimage.binary_erosion(mask, structure=struct, border_value=0)
    return mask & ~eroded


def surface_distances(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Directed surface-to-surface distance sets.

    Returns ``(d_pred_to_target, d_target_to_pred)``: for every surface
    voxel of one mask, the Euclidean distance (in ``spacing`` units) to the
    nearest surface voxel of the other. Either array is empty when the
    corresponding mask is empty.
    """
    from scipy import ndimage

    pred, target = _as_bool(pred), _as_bool(target)
    sp, st = _surface(pred), _surface(target)
    spacing = tuple(float(s) for s in spacing)

    if sp.any() and st.any():
        # EDT of the complement of a surface = distance-to-that-surface
        # field; sampling it at the other surface's voxels gives the
        # directed distance set in one vectorized pass.
        dist_to_t = ndimage.distance_transform_edt(~st, sampling=spacing)
        dist_to_p = ndimage.distance_transform_edt(~sp, sampling=spacing)
        return dist_to_t[sp], dist_to_p[st]
    d_p2t = np.zeros(int(sp.sum()), np.float64)
    d_t2p = np.zeros(int(st.sum()), np.float64)
    if sp.any() != st.any():  # exactly one empty: no finite distance exists
        d_p2t[:] = np.inf
        d_t2p[:] = np.inf
    return d_p2t, d_t2p


def hausdorff_distance(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    percentile: float = 95.0,
) -> float:
    """Robust Hausdorff: max over directions of the p-th percentile of the
    directed distances (p=100 recovers the classical Hausdorff distance)."""
    d_p2t, d_t2p = surface_distances(pred, target, spacing)
    if d_p2t.size == 0 and d_t2p.size == 0:
        return 0.0
    if d_p2t.size == 0 or d_t2p.size == 0 or not (
        np.isfinite(d_p2t).all() and np.isfinite(d_t2p).all()
    ):
        return float("inf")
    return float(
        max(np.percentile(d_p2t, percentile), np.percentile(d_t2p, percentile))
    )


def assd(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> float:
    """Average symmetric surface distance: mean over both directed sets."""
    d_p2t, d_t2p = surface_distances(pred, target, spacing)
    n = d_p2t.size + d_t2p.size
    if n == 0:
        return 0.0
    total = float(d_p2t.sum() + d_t2p.sum())  # inf propagates correctly
    return total / n


def surface_dice(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    tolerance: float = 1.0,
) -> float:
    """Normalized surface Dice at ``tolerance`` (same units as spacing):
    the fraction of all surface points lying within tolerance of the other
    surface. 1.0 = every boundary point agrees to within the tolerance."""
    d_p2t, d_t2p = surface_distances(pred, target, spacing)
    n = d_p2t.size + d_t2p.size
    if n == 0:
        return 1.0
    hits = int((d_p2t <= tolerance).sum() + (d_t2p <= tolerance).sum())
    return hits / n


def case_surface_metrics(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    percentile: float = 95.0,
    tolerance: float = 1.0,
) -> dict:
    """All three metrics from ONE pair of distance transforms (the EDTs
    dominate the cost; the validator calls this, not the one-off wrappers)."""
    d_p2t, d_t2p = surface_distances(pred, target, spacing)
    n = d_p2t.size + d_t2p.size
    if n == 0:
        return {"hd95": 0.0, "assd": 0.0, "surface_dice": 1.0}
    if d_p2t.size == 0 or d_t2p.size == 0 or not (
        np.isfinite(d_p2t).all() and np.isfinite(d_t2p).all()
    ):
        return {"hd95": float("inf"), "assd": float("inf"), "surface_dice": 0.0}
    hd = max(np.percentile(d_p2t, percentile), np.percentile(d_t2p, percentile))
    mean = (d_p2t.sum() + d_t2p.sum()) / n
    hits = int((d_p2t <= tolerance).sum() + (d_t2p <= tolerance).sum())
    return {
        "hd95": float(hd),
        "assd": float(mean),
        "surface_dice": hits / n,
    }
