"""Case discovery, filtering, missing-modality strategies and preprocessing.

The port of ``pcmseg_tpu/data/dataset.py`` without ``ml_dtypes`` (which
that module imports, and which the machine with the GPU lacks). Discovery,
filtering, the ``{data_dir}/BPH-PCA/{data_type}/{modality}/{case}`` tree
with labels under ``LABEL_DIR``, the preprocessing and the ``.npz`` cache
(format ``v2-bf16u8``: ``image_bf16`` as uint16 bits, ``label_u8``) are the
JAX package's, under the same ``_cache_key``, so a cache entry that either
package wrote is read by the other.

The host wire format differs: the image is float32 holding bf16 values
(rounded to nearest even, as ``ml_dtypes`` rounds, via torch), since numpy
has no bf16. Batches are cast to bf16 on their way to the device, which is
exact. With augmentation off, or flips and rotations only, the batches
equal the JAX package's bit for bit; the intensity transforms round once
at the end here and after every operation there (within one bf16 ulp).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES
from pcmseg_tpu_torch.data.io import ALL_EXTS, read_header, read_volume, strip_ext
from pcmseg_tpu_torch.data.resample import normalize_intensity, resample_array

LABEL_DIR = "ROI(BPH+PCA)"


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 → float32 holding the nearest bf16 values (ties to even)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 array of bf16 values → their uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns → float32 values."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


@dataclass
class CaseRecord:
    case_id: str
    modality_files: Dict[str, str]
    label_path: str
    missing_modalities: List[str] = field(default_factory=list)


def _find_case_file(directory: str, case_id: str) -> Optional[str]:
    for ext in ALL_EXTS:
        p = os.path.join(directory, case_id + ext)
        if os.path.exists(p):
            return p
    return None


def resolve_cache_dir(cache_dir: Optional[str]) -> Optional[str]:
    """Resolve the preprocessing-cache location.

    'auto' (the config default) → $PCMSEG_CACHE_DIR, falling back to
    ~/.cache/pcmseg/preproc. Cache keys are content-aware (paths, mtimes,
    preprocessing params — see ``ProstateDataset._cache_key``), so a
    shared directory is safe across runs and datasets. None/'' disables.
    """
    if not cache_dir:
        return None
    if cache_dir != "auto":
        return cache_dir
    env = os.environ.get("PCMSEG_CACHE_DIR")
    if env == "":
        return None  # explicit opt-out
    return env or os.path.expanduser("~/.cache/pcmseg/preproc")


class ProstateDataset:
    """Multimodal prostate MRI dataset over a BPH/PCA data tree."""

    def __init__(
        self,
        data_dir: str,
        data_type: str = "BPH",
        modalities: Sequence[str] = DEFAULT_MODALITIES,
        missing_strategy: str = "zero_fill",
        target_size: Tuple[int, int, int] = (128, 128, 128),
        normalize: str = "percentile",
        norm_percentiles: Tuple[float, float] = (1.0, 99.0),
        cache_dir: Optional[str] = None,
        is_training: bool = True,
        verbose: bool = False,
        n_classes: int = 1,
        coregister: bool = False,
    ):
        if missing_strategy not in ("zero_fill", "skip", "duplicate"):
            raise ValueError(f"unknown missing_strategy: {missing_strategy!r}")
        # n_classes <= 1: binary — labels binarized (>0), parity with the
        # reference (data_loader.py label handling). n_classes >= 2:
        # integer class maps preserved (rounded, clipped to 0..K-1) for
        # the softmax multi-class path (ops/losses.py multi-class section).
        self.n_classes = int(n_classes)
        # physical-space modality co-registration (beyond-reference,
        # config.coregister): every modality and the label are resampled
        # onto the anchor (first available) modality's grid by PHYSICAL
        # coordinates before the index-space resize to target_size —
        # data/resample.py::resample_to_grid. Off by default: the
        # reference stacks index-space arrays (data_loader.py:352-377)
        # and parity mode reproduces that.
        self.coregister = bool(coregister)
        self.data_dir = data_dir
        self.data_type = data_type
        self.modalities = list(modalities)
        self.missing_strategy = missing_strategy
        self.target_size = tuple(target_size)
        self.normalize = normalize
        self.norm_percentiles = tuple(norm_percentiles)
        self.cache_dir = resolve_cache_dir(cache_dir)
        self.is_training = is_training
        self.verbose = verbose
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

        self.case_list: List[CaseRecord] = self._filter_cases(self._scan_case_ids())

    # -- discovery ------------------------------------------------------------

    def _modality_dir(self, modality: str) -> str:
        return os.path.join(self.data_dir, "BPH-PCA", self.data_type, modality)

    def _label_dir(self) -> str:
        return os.path.join(self.data_dir, "BPH-PCA", LABEL_DIR, self.data_type)

    def _scan_case_ids(self) -> List[str]:
        """Case IDs come from the ADC (first-modality) directory listing."""
        anchor = self._modality_dir(self.modalities[0])
        if not os.path.isdir(anchor):
            if self.verbose:
                print(f"warning: anchor modality dir not found: {anchor}")
            return []
        ids = sorted(
            {
                strip_ext(f)
                for f in os.listdir(anchor)
                if f.lower().endswith(tuple(e.lower() for e in ALL_EXTS))
            }
        )
        if self.verbose:
            print(
                f"scanned {len(ids)} cases ({self.data_type}, "
                f"strategy={self.missing_strategy})"
            )
        return ids

    def _filter_cases(self, case_ids: List[str]) -> List[CaseRecord]:
        valid: List[CaseRecord] = []
        for case_id in case_ids:
            modality_files: Dict[str, str] = {}
            missing: List[str] = []
            for modality in self.modalities:
                p = _find_case_file(self._modality_dir(modality), case_id)
                if p:
                    modality_files[modality] = p
                else:
                    missing.append(modality)

            label_path = _find_case_file(self._label_dir(), case_id)
            if label_path is None:
                if self.verbose:
                    print(f"warning: case {case_id} has no label; skipped")
                continue

            if missing:
                if self.missing_strategy == "skip":
                    if self.verbose:
                        print(f"warning: case {case_id} missing {missing}; skipped")
                    continue
                if self.missing_strategy == "duplicate":
                    if not modality_files:
                        continue  # nothing to duplicate from
                    donor = next(
                        m for m in self.modalities if m in modality_files
                    )
                    for m in missing:
                        modality_files[m] = modality_files[donor]
                # zero_fill: handled at load time

            # readability probe (cheap header parse)
            try:
                for p in set(modality_files.values()):
                    read_header(p)
                read_header(label_path)
            except Exception as e:  # noqa: BLE001 — any parse error disqualifies
                if self.verbose:
                    print(f"warning: case {case_id} unreadable ({e}); skipped")
                continue

            valid.append(
                CaseRecord(
                    case_id=case_id,
                    modality_files=modality_files,
                    label_path=label_path,
                    missing_modalities=missing,
                )
            )
        if self.verbose:
            print(f"dataset ready: {len(valid)} valid cases")
        return valid

    @property
    def case_ids(self) -> List[str]:
        return [c.case_id for c in self.case_list]

    # -- loading ---------------------------------------------------------------

    # bump when the on-disk entry layout changes; keying the format keeps
    # old-format entries from being served (mixing fp32 v1 with bf16 v2
    # batches would retrace the step on every dtype flip)
    _CACHE_FORMAT = "v2-bf16u8"

    def _cache_key(self, rec: CaseRecord) -> str:
        h = hashlib.sha1()
        h.update(repr((
            self._CACHE_FORMAT,
            rec.case_id,
            self.target_size,
            self.normalize,
            self.norm_percentiles,
            tuple(self.modalities),
            # part of the key only when multi-class so every existing
            # binary cache entry stays valid
            *(
                (("n_classes", self.n_classes),)
                if self.n_classes >= 2
                else ()
            ),
            *((("coregister", True),) if self.coregister else ()),
        )).encode())
        for m in self.modalities:
            p = rec.modality_files.get(m)
            h.update(
                repr((m, p, os.path.getmtime(p) if p else None)).encode()
            )
        h.update(
            repr((rec.label_path, os.path.getmtime(rec.label_path))).encode()
        )
        return h.hexdigest()

    def _load_modality(
        self, rec: CaseRecord, modality: str, ref_vol=None
    ) -> np.ndarray:
        """One modality → normalized (D,H,W) float32 at target_size.

        With ``ref_vol`` (the co-registration anchor) the volume is first
        resampled onto the anchor's grid by physical coordinates."""
        path = rec.modality_files.get(modality)
        if path is None:
            if self.missing_strategy == "zero_fill":
                return np.zeros(self.target_size, dtype=np.float32)
            raise RuntimeError(
                f"modality {modality} missing for case {rec.case_id} under "
                f"strategy {self.missing_strategy}"
            )
        try:
            vol = read_volume(path)
        except Exception:
            if self.missing_strategy == "zero_fill":
                # parity with the reference's zero-fill-on-read-failure
                # (data_loader.py:231-238)
                return np.zeros(self.target_size, dtype=np.float32)
            raise
        if ref_vol is not None:
            from pcmseg_tpu_torch.data.resample import resample_to_grid

            vol = resample_to_grid(vol, ref_vol, mode="linear")
        data = resample_array(vol.data, self.target_size, mode="linear")
        return normalize_intensity(data, self.normalize, self.norm_percentiles)

    def load_case(self, idx: int) -> Dict[str, np.ndarray]:
        """Load + preprocess one case → {'image','label','case_id'}.

        Wire format: image float32 holding bf16 values, label uint8 (see
        the module docstring); the cache stores the bf16 bits.
        """
        rec = self.case_list[idx]

        if self.cache_dir:
            cpath = os.path.join(self.cache_dir, self._cache_key(rec) + ".npz")
            if os.path.exists(cpath):
                z = np.load(cpath)
                # v2 layout: bf16 bits stored as uint16 + uint8 labels; the
                # format tag in the key guarantees no older-layout entry
                # resolves here
                return {
                    "image": from_bf16_bits(z["image_bf16"]),
                    "label": z["label_u8"],
                    "case_id": rec.case_id,
                }

        ref_vol = None
        if self.coregister:
            for m in self.modalities:
                p = rec.modality_files.get(m)
                if not p:
                    continue
                try:
                    ref_vol = read_volume(p)
                    break
                except Exception:
                    continue
        channels = [
            self._load_modality(rec, m, ref_vol) for m in self.modalities
        ]
        image = bf16_round(np.stack(channels, axis=-1))  # (D,H,W,C)

        label_vol = read_volume(rec.label_path)
        if ref_vol is not None:
            from pcmseg_tpu_torch.data.resample import resample_to_grid

            label_vol = resample_to_grid(label_vol, ref_vol, mode="nearest")
        label = resample_array(label_vol.data, self.target_size, mode="nearest")
        if self.n_classes >= 2:
            label = np.clip(
                np.rint(label), 0, self.n_classes - 1
            ).astype(np.uint8)[..., None]  # (D,H,W,1) class map
        else:
            label = (label > 0).astype(np.uint8)[..., None]  # (D,H,W,1)

        if self.cache_dir:
            # tmp name must be unique PER WRITER: concurrent processes
            # (multi-host workers on a shared cache, parallel CV folds)
            # decode the same case and race to publish the same key — a
            # shared tmp path lets one os.replace consume the other's
            # file (observed: FileNotFoundError on a 4-process cluster).
            # Unique tmp + atomic replace = last writer wins, identical
            # bytes either way (the pipeline is deterministic).
            tmp = f"{cpath}.tmp.{os.getpid()}.npz"
            np.savez(tmp, image_bf16=bf16_bits(image), label_u8=label)
            os.replace(tmp, cpath)

        return {"image": image, "label": label, "case_id": rec.case_id}

    def __len__(self) -> int:
        return len(self.case_list)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.load_case(idx)
