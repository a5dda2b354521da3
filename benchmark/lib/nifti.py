"""Single-file NIfTI-1 (``.nii.gz``) written and read with numpy and gzip:
the benchmark's own input files and its reading of the masks the program
writes. Arrays are (D, H, W) = (z, y, x); the file holds x fastest, and the
affine in the sform rows."""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

HEADER = 348
CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16}
DTYPES = {v: k for k, v in CODES.items()}


def write(path: str, data: np.ndarray, affine: np.ndarray, level: int = 1) -> None:
    """``data`` (D, H, W) with the 4×4 voxel-to-world ``affine`` (sform, code 1)."""
    data = np.ascontiguousarray(data)
    d, h, w = data.shape
    hdr = bytearray(HEADER + 4)
    struct.pack_into("<i", hdr, 0, HEADER)
    struct.pack_into("<8h", hdr, 40, 3, w, h, d, 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, CODES[data.dtype], data.dtype.itemsize * 8)
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<ff", hdr, 108, HEADER + 4.0, 1.0)  # vox_offset, scl_slope
    struct.pack_into("<hh", hdr, 252, 0, 1)  # qform_code, sform_code
    for row in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * row, *affine[row])
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(hdr))
        f.write(data.tobytes())


def read(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(data (D, H, W) in the file's dtype, the sform affine as float32 holds it)."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != HEADER:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dims = struct.unpack_from("<8h", raw, 40)
    code = struct.unpack_from("<h", raw, 70)[0]
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    w, h, d = dims[1:4]
    data = np.frombuffer(raw, dtype=DTYPES[code], count=w * h * d, offset=offset).reshape(d, h, w)
    affine = np.eye(4)
    if struct.unpack_from("<h", raw, 254)[0] > 0:
        for row in range(3):
            affine[row] = struct.unpack_from("<4f", raw, 280 + 16 * row)
    return data, affine
