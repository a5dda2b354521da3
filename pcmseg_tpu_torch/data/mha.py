"""MetaImage (.mha / .mhd) reader/writer in pure numpy.

The reference's README documents .mha support via SimpleITK
(reference README.md:114); this implements the MetaIO format directly:
a text key=value header followed by raw (optionally zlib-compressed)
voxel data, x-fastest on disk like NIfTI.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Union

import numpy as np

from pcmseg_tpu_torch.data.volume import Volume

_MET_TYPES = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16,
    "MET_UINT": np.uint32,
    "MET_INT": np.int32,
    "MET_ULONG_LONG": np.uint64,
    "MET_LONG_LONG": np.int64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_TYPE_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def _parse_header(data: bytes) -> (Dict[str, str], int):
    """Parse 'Key = Value' lines until ElementDataFile; return fields + offset."""
    fields: Dict[str, str] = {}
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise ValueError("MetaImage header missing ElementDataFile terminator")
        line = data[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"malformed MetaImage header line: {line!r}")
        key, value = (s.strip() for s in line.split("=", 1))
        fields[key] = value
        if key == "ElementDataFile":
            return fields, pos


def read_mha(path: str) -> Volume:
    with open(path, "rb") as f:
        raw = f.read()
    fields, offset = _parse_header(raw)

    ndims = int(fields.get("NDims", "3"))
    if ndims != 3:
        raise ValueError(f"only 3D MetaImages supported, got NDims={ndims}")
    size_xyz = [int(s) for s in fields["DimSize"].split()]
    dtype = _MET_TYPES.get(fields.get("ElementType", "MET_FLOAT"))
    if dtype is None:
        raise ValueError(f"unsupported ElementType {fields.get('ElementType')!r}")
    byte_order_msb = fields.get(
        "BinaryDataByteOrderMSB", fields.get("ElementByteOrderMSB", "False")
    )
    spacing = tuple(
        float(s) for s in fields.get("ElementSpacing", "1 1 1").split()
    )
    origin = tuple(
        float(s) for s in fields.get("Offset", fields.get("Position", "0 0 0")).split()
    )
    direction = np.array(
        [float(s) for s in fields.get("TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]
    ).reshape(3, 3).T  # MetaIO stores row-major axis vectors

    datafile = fields["ElementDataFile"]
    if datafile.upper() == "LOCAL":
        payload = raw[offset:]
    else:
        with open(os.path.join(os.path.dirname(path), datafile), "rb") as f:
            payload = f.read()

    if fields.get("CompressedData", "False").lower() == "true":
        payload = zlib.decompress(payload)

    n_vox = int(np.prod(size_xyz))
    dt = np.dtype(dtype)
    if byte_order_msb.lower() == "true":
        dt = dt.newbyteorder(">")
    data = np.frombuffer(payload, dtype=dt, count=n_vox).reshape(size_xyz[::-1])
    if data.dtype.byteorder == ">":
        data = data.astype(data.dtype.newbyteorder("="))
    return Volume(
        data=np.ascontiguousarray(data),
        spacing=spacing,
        origin=origin,
        direction=direction,
    )


def write_mha(
    vol_or_array: Union[Volume, np.ndarray], path: str, compressed: bool = False
) -> None:
    vol = (
        vol_or_array
        if isinstance(vol_or_array, Volume)
        else Volume(np.asarray(vol_or_array))
    )
    data = np.asarray(vol.data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _TYPE_NAMES:
        data = data.astype(np.float32)

    w, h, d = vol.size_xyz
    tm = " ".join(f"{x:g}" for x in vol.direction.T.reshape(-1))
    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        f"TransformMatrix = {tm}",
        f"Offset = {vol.origin[0]:g} {vol.origin[1]:g} {vol.origin[2]:g}",
        f"ElementSpacing = {vol.spacing[0]:g} {vol.spacing[1]:g} {vol.spacing[2]:g}",
        f"DimSize = {w} {h} {d}",
        f"ElementType = {_TYPE_NAMES[np.dtype(data.dtype)]}",
        "ElementDataFile = LOCAL",
    ]
    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = zlib.compress(payload)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(payload)
