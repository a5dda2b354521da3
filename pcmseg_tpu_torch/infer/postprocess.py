"""Binary-mask postprocessing for serving and validation.

The port's copy of ``pcmseg_tpu/infer/postprocess.py``.

Prostate lesions are single (or few) compact structures, so a common
deployment step after thresholding is connected-component filtering:
keep the largest foreground component and/or drop speckle components
below a voxel count. The reference has nothing here (its predictor
writes the raw thresholded mask, script/predict.py:174-197); nnU-Net
ships the same filter as its default postprocessing, which is the model
for this module.

Host-side numpy/scipy on purpose, like ops/surface.py: connected-
component labeling is a sequential union-find over an irregular sparse
set — a poor fit for the tensor cores — and it runs on the already-fetched uint8
mask (6 MB/case), overlapped with the device's next case.
"""

from __future__ import annotations

import numpy as np

POSTPROCESS_MODES = ("none", "largest_cc")


def postprocess_mask(
    mask: np.ndarray,
    mode: str = "largest_cc",
    min_voxels: int = 0,
    connectivity: int = 1,
) -> np.ndarray:
    """Filter a binary (D,H,W) mask by connected components.

    mode='largest_cc' keeps only the largest foreground component;
    mode='none' keeps all. Independently, ``min_voxels`` > 0 removes
    every component smaller than that count (applied first, so a
    largest-but-tiny speckle on an otherwise-empty mask is dropped too).
    ``connectivity`` is scipy's 3-D face(1)/edge(2)/corner(3) adjacency.
    Empty masks pass through unchanged. Returns uint8, same shape.
    """
    if mode not in POSTPROCESS_MODES:
        raise ValueError(
            f"postprocess={mode!r}; expected one of {POSTPROCESS_MODES}"
        )
    mask = np.asarray(mask)
    out = (mask > 0).astype(np.uint8)
    if mode == "none" and min_voxels <= 0:
        return out
    if not out.any():
        return out
    from scipy import ndimage

    structure = ndimage.generate_binary_structure(3, connectivity)
    labels, n = ndimage.label(out, structure=structure)
    if n <= 0:
        return out
    counts = np.bincount(labels.ravel())
    counts[0] = 0  # background
    keep = np.zeros_like(counts, dtype=bool)
    if min_voxels > 0:
        keep = counts >= min_voxels
    else:
        keep[1:] = True
    if mode == "largest_cc":
        largest = int(counts.argmax())
        only_largest = np.zeros_like(keep)
        only_largest[largest] = keep[largest]
        keep = only_largest
    return keep[labels].astype(np.uint8)


def postprocess_labelmap(
    labels: np.ndarray,
    mode: str = "largest_cc",
    min_voxels: int = 0,
    connectivity: int = 1,
) -> np.ndarray:
    """Per-class component filtering of an integer (D,H,W) label map.

    Each foreground class c >= 1 is filtered independently with
    :func:`postprocess_mask`; voxels whose class component was dropped
    revert to background 0. Returns uint8, same shape.
    """
    labels = np.asarray(labels)
    out = np.zeros_like(labels, dtype=np.uint8)
    for c in np.unique(labels):
        if c == 0:
            continue
        kept = postprocess_mask(
            labels == c, mode=mode, min_voxels=min_voxels,
            connectivity=connectivity,
        )
        out[kept > 0] = c
    return out


def postprocess_from_config(mask: np.ndarray, config) -> np.ndarray:
    """Apply the config's postprocess settings (identity when 'none').

    Binary (n_classes <= 1) masks use :func:`postprocess_mask`;
    multi-class label maps are filtered per class via
    :func:`postprocess_labelmap`.
    """
    mode = getattr(config, "postprocess", "none")
    min_voxels = int(getattr(config, "min_component_voxels", 0))
    if mode == "none" and min_voxels <= 0:
        return np.asarray(mask)
    if int(getattr(config, "n_classes", 1)) >= 2:
        return postprocess_labelmap(mask, mode=mode, min_voxels=min_voxels)
    return postprocess_mask(mask, mode=mode, min_voxels=min_voxels)
