"""Volume: a 3D image array plus its spatial metadata.

The in-memory equivalent of a SimpleITK image in the reference pipeline:
array data in (D, H, W) = (z, y, x) order (what sitk.GetArrayFromImage
returned to the reference at script/data_loader.py:205), together with the
physical-space metadata (spacing/origin/direction in x,y,z order, matching
SITK conventions) that the reference carried via ``CopyInformation``
(script/predict.py:174-197).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class Volume:
    """3D volume with SITK-convention spatial metadata.

    Attributes:
      data: (D, H, W) array, i.e. indexed [z, y, x].
      spacing: physical voxel size (sx, sy, sz) — x,y,z order.
      origin: physical position of voxel (0,0,0) — x,y,z order.
      direction: 3x3 direction cosine matrix (rows map x,y,z axes),
        identity by default.
    """

    data: np.ndarray
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: np.ndarray = field(
        default_factory=lambda: np.eye(3, dtype=np.float64)
    )

    def __post_init__(self):
        self.data = np.asarray(self.data)
        if self.data.ndim != 3:
            raise ValueError(f"Volume data must be 3D (D,H,W), got {self.data.shape}")
        self.spacing = tuple(float(s) for s in self.spacing)
        self.origin = tuple(float(o) for o in self.origin)
        self.direction = np.asarray(self.direction, dtype=np.float64).reshape(3, 3)

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(D, H, W) array shape."""
        return self.data.shape

    @property
    def size_xyz(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — SITK GetSize() order."""
        d, h, w = self.data.shape
        return (w, h, d)

    @property
    def affine(self) -> np.ndarray:
        """4x4 voxel(x,y,z)->physical affine (NIfTI convention)."""
        aff = np.eye(4)
        aff[:3, :3] = self.direction @ np.diag(self.spacing)
        aff[:3, 3] = self.origin
        return aff

    def copy_information(self, other: "Volume") -> "Volume":
        """Adopt another volume's spatial metadata (sitk CopyInformation)."""
        if self.shape != other.shape:
            raise ValueError(
                f"copy_information requires matching shapes: "
                f"{self.shape} vs {other.shape}"
            )
        self.spacing = other.spacing
        self.origin = other.origin
        self.direction = other.direction.copy()
        return self

    def with_data(self, data: np.ndarray) -> "Volume":
        """New Volume with the same metadata and different voxel data."""
        return Volume(
            data=data,
            spacing=self.spacing,
            origin=self.origin,
            direction=self.direction.copy(),
        )

    @classmethod
    def from_affine(cls, data: np.ndarray, affine: np.ndarray) -> "Volume":
        """Build from a 4x4 NIfTI-style affine (voxel x,y,z → physical)."""
        affine = np.asarray(affine, dtype=np.float64)
        m = affine[:3, :3]
        spacing = np.linalg.norm(m, axis=0)
        spacing = np.where(spacing == 0, 1.0, spacing)
        direction = m / spacing[None, :]
        return cls(
            data=data,
            spacing=tuple(spacing),
            origin=tuple(affine[:3, 3]),
            direction=direction,
        )
