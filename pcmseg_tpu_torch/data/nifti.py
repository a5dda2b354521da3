"""NIfTI-1 reader/writer in pure numpy (``.nii`` / ``.nii.gz``).

SimpleITK — the reference's I/O backend (script/data_loader.py:196-238) —
is not available in this image, so this is a from-scratch implementation of
the NIfTI-1 on-disk format: 348-byte header, optional gzip container,
scl_slope/scl_inter scaling, sform/qform affines, and both byte orders.

Conventions:
  * Arrays are returned as (D, H, W) = (z, y, x), matching what
    sitk.GetArrayFromImage handed the reference.
  * Spatial metadata goes through :class:`pcmseg_tpu_torch.data.volume.Volume`;
    the affine is taken from sform when sform_code > 0, else qform, else a
    pixdim-diagonal fallback (nibabel-compatible precedence).
  * ``write_nifti`` emits single-file NIfTI-1 (magic ``n+1``) with the
    volume's affine in both sform and qform-less form; reading back a
    written file round-trips data and metadata exactly.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import BinaryIO, Tuple, Union

import numpy as np

from pcmseg_tpu_torch.data.volume import Volume

HEADER_SIZE = 348
MAGIC_SINGLE = b"n+1\x00"
MAGIC_PAIR = b"ni1\x00"

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open_maybe_gz(path: str, mode: str) -> BinaryIO:
    if str(path).endswith(".gz"):
        if "w" in mode:
            # level 1: masks/synthetic volumes compress to within ~15% of
            # level 9 at a fraction of the CPU — gz writes sat on the
            # serving loop's critical path at the default level 9
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    return open(path, mode)


def _read_file_bytes(path: str) -> bytes:
    """Whole-file read with one-shot gzip inflation.

    gzip.GzipFile.read() inflates through a chunked-copy streaming path;
    a single zlib.decompressobj pass over the mmapped-in bytes is
    measurably faster on the multi-MB volumes the serving loop decodes
    (zlib was the largest host-decode share — BENCH.md configs[4]).
    Handles multi-member gzip (bgzip-style) by iterating members.
    """
    with open(path, "rb") as f:
        comp = f.read()
    if not (str(path).endswith(".gz") and comp[:2] == b"\x1f\x8b"):
        return comp
    parts = []
    while comp:
        obj = zlib.decompressobj(wbits=31)
        parts.append(obj.decompress(comp))
        if not obj.eof:  # truncated stream — surface like gzip would
            raise EOFError(f"truncated gzip stream in {path!r}")
        comp = obj.unused_data
        if comp[:2] != b"\x1f\x8b":  # trailing pad bytes, not a member
            break
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _quaternion_to_direction(b, c, d, qfac) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    r[:, 2] *= qfac
    return r


class NiftiHeader:
    """Parsed NIfTI-1 header — enough fields for read/write + metadata."""

    def __init__(self, raw: bytes):
        if len(raw) < HEADER_SIZE:
            raise ValueError(f"truncated NIfTI header ({len(raw)} bytes)")
        sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
        self.byteorder = "<"
        if sizeof_hdr != HEADER_SIZE:
            sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
            if sizeof_hdr != HEADER_SIZE:
                raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
            self.byteorder = ">"
        bo = self.byteorder
        self.dim = struct.unpack(bo + "8h", raw[40:56])
        self.datatype = struct.unpack(bo + "h", raw[70:72])[0]
        self.bitpix = struct.unpack(bo + "h", raw[72:74])[0]
        self.pixdim = struct.unpack(bo + "8f", raw[76:108])
        self.vox_offset = struct.unpack(bo + "f", raw[108:112])[0]
        self.scl_slope = struct.unpack(bo + "f", raw[112:116])[0]
        self.scl_inter = struct.unpack(bo + "f", raw[116:120])[0]
        self.qform_code = struct.unpack(bo + "h", raw[252:254])[0]
        self.sform_code = struct.unpack(bo + "h", raw[254:256])[0]
        self.quatern = struct.unpack(bo + "3f", raw[256:268])
        self.qoffset = struct.unpack(bo + "3f", raw[268:280])
        self.srow_x = struct.unpack(bo + "4f", raw[280:296])
        self.srow_y = struct.unpack(bo + "4f", raw[296:312])
        self.srow_z = struct.unpack(bo + "4f", raw[312:328])
        self.magic = raw[344:348]
        if self.magic not in (MAGIC_SINGLE, MAGIC_PAIR):
            raise ValueError(f"bad NIfTI magic: {self.magic!r}")

    @property
    def ndim(self) -> int:
        return self.dim[0]

    @property
    def shape_xyz(self) -> Tuple[int, ...]:
        return tuple(self.dim[1 : 1 + max(self.ndim, 3)])

    @property
    def numpy_dtype(self) -> np.dtype:
        if self.datatype not in _DTYPES:
            raise ValueError(f"unsupported NIfTI datatype code {self.datatype}")
        return np.dtype(_DTYPES[self.datatype]).newbyteorder(self.byteorder)

    @property
    def affine(self) -> np.ndarray:
        aff = np.eye(4)
        if self.sform_code > 0:
            aff[0, :] = self.srow_x
            aff[1, :] = self.srow_y
            aff[2, :] = self.srow_z
        elif self.qform_code > 0:
            # the qform-only decode path: untested here as in the JAX package
            qfac = -1.0 if self.pixdim[0] < 0 else 1.0
            r = _quaternion_to_direction(*self.quatern, qfac)
            aff[:3, :3] = r @ np.diag(self.pixdim[1:4])
            aff[:3, 3] = self.qoffset
        else:
            aff[:3, :3] = np.diag([p if p != 0 else 1.0 for p in self.pixdim[1:4]])
        return aff


def read_nifti_header(path: str) -> NiftiHeader:
    """Read just the header — the cheap readability probe the reference did
    with sitk.ImageFileReader().ReadImageInformation() (data_loader.py:168-172)."""
    with _open_maybe_gz(path, "rb") as f:
        return NiftiHeader(f.read(HEADER_SIZE))


def read_nifti(path: str) -> Volume:
    """Read a .nii / .nii.gz into a Volume ((D,H,W) data + affine metadata).

    4D inputs keep the first timepoint/channel, as the reference did
    (script/data_loader.py:213-218).
    """
    raw = _read_file_bytes(path)
    hdr = NiftiHeader(raw[:HEADER_SIZE])
    shape_xyz = [max(int(s), 1) for s in hdr.dim[1 : 1 + max(hdr.ndim, 3)]]
    n_vox = int(np.prod(shape_xyz))
    offset = int(hdr.vox_offset) if hdr.vox_offset >= HEADER_SIZE else HEADER_SIZE
    dt = hdr.numpy_dtype
    data = np.frombuffer(raw, dtype=dt, count=n_vox, offset=offset)
    # file order is x-fastest (Fortran); C-reshape with reversed dims
    # gives [..., z, y, x]
    data = data.reshape(shape_xyz[::-1])
    while data.ndim > 3:
        data = data[0]  # keep first timepoint/channel of 4D+ images
    slope, inter = hdr.scl_slope, hdr.scl_inter
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter
    else:
        data = np.ascontiguousarray(data)
        if data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("="))
    return Volume.from_affine(data, hdr.affine)


def write_nifti(vol_or_array: Union[Volume, np.ndarray], path: str) -> None:
    """Write a Volume (or bare (D,H,W) array) as single-file NIfTI-1."""
    vol = (
        vol_or_array
        if isinstance(vol_or_array, Volume)
        else Volume(np.asarray(vol_or_array))
    )
    data = np.asarray(vol.data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    d, h, w = data.shape
    affine = vol.affine

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, w, h, d, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into(
        "<8f", hdr, 76, 1.0, vol.spacing[0], vol.spacing[1], vol.spacing[2],
        0.0, 0.0, 0.0, 0.0,
    )
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset (hdr + 4 ext bytes)
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = MAGIC_SINGLE

    # x must be fastest on disk: C-order bytes of the (z,y,x) array are
    # exactly that.
    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.ascontiguousarray(data).tobytes()
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
