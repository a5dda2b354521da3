"""Format-dispatching volume I/O (.nii / .nii.gz / .mha / .mhd)."""

from __future__ import annotations

from typing import Union

import numpy as np

from pcmseg_tpu_torch.data.mha import read_mha, write_mha
from pcmseg_tpu_torch.data.nifti import read_nifti, read_nifti_header, write_nifti
from pcmseg_tpu_torch.data.volume import Volume

NIFTI_EXTS = (".nii", ".nii.gz")
MHA_EXTS = (".mha", ".mhd")
ALL_EXTS = NIFTI_EXTS + MHA_EXTS


def _is_nifti(path: str) -> bool:
    p = str(path).lower()
    return p.endswith(".nii") or p.endswith(".nii.gz")


def _is_mha(path: str) -> bool:
    p = str(path).lower()
    return p.endswith(".mha") or p.endswith(".mhd")


def read_volume(path: str) -> Volume:
    if _is_nifti(path):
        return read_nifti(path)
    if _is_mha(path):
        return read_mha(path)
    raise ValueError(f"unsupported volume format: {path}")


def write_volume(vol: Union[Volume, np.ndarray], path: str) -> None:
    if _is_nifti(path):
        write_nifti(vol, path)
    elif _is_mha(path):
        write_mha(vol, path)
    else:
        raise ValueError(f"unsupported volume format: {path}")


def read_header(path: str):
    """Cheap readability/integrity probe (the reference's
    ReadImageInformation check, data_loader.py:165-183). Raises on
    corrupt/unreadable files."""
    if _is_nifti(path):
        return read_nifti_header(path)
    if _is_mha(path):
        # MetaIO has no compact fixed header; parse the text header only.
        from pcmseg_tpu_torch.data.mha import _parse_header

        with open(path, "rb") as f:
            head = f.read(65536)
        fields, _ = _parse_header(head)
        return fields
    raise ValueError(f"unsupported volume format: {path}")


def strip_ext(filename: str) -> str:
    """Case ID from a filename (reference data_loader.py:79-89)."""
    for ext in (".nii.gz", ".nii", ".mha", ".mhd"):
        if filename.lower().endswith(ext):
            return filename[: -len(ext)]
    return filename
