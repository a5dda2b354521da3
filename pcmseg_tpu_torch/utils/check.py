"""Project health checker → project_check_report.json.

The port of ``pcmseg_tpu/utils/check.py``, with the same report keys
(``dependencies``, ``devices``, ``data``, ``checkpoints``, ``files``,
``ok``): the dependencies are this package's (torch, numpy, scipy), the
devices come from ``torch.cuda``, the checkpoints are the port's ``.pt``
training checkpoints and ``.pth`` files, and the package files are the
port's own. Without a card ``ok`` is false unless the check is asked for
the CPU (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List, Optional

import torch

from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES
from pcmseg_tpu_torch.data.dataset import LABEL_DIR
from pcmseg_tpu_torch.utils.artifacts import write_json

REQUIRED_PACKAGES = ["torch", "numpy", "scipy"]
OPTIONAL_PACKAGES = ["sklearn", "triton", "einops"]
CHECKPOINT_EXTS = (".pt", ".pth")


def check_dependencies() -> Dict:
    out = {"required": {}, "optional": {}, "ok": True}
    for name, bucket in [(p, "required") for p in REQUIRED_PACKAGES] + [
        (p, "optional") for p in OPTIONAL_PACKAGES
    ]:
        try:
            mod = importlib.import_module(name)
            out[bucket][name] = getattr(mod, "__version__", "unknown")
        except ImportError:
            out[bucket][name] = None
            if bucket == "required":
                out["ok"] = False
    return out


def check_devices(device: str = "cuda") -> Dict:
    """The CUDA devices; ``ok`` when there is one, or when the CPU was asked for."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "ok": count > 0 or device == "cpu",
        "backend": device,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
    }


def check_data_directory(data_dir: str, data_types: Optional[List[str]] = None) -> Dict:
    """Validate the BPH-PCA tree layout + per-modality file counts."""
    data_types = data_types or ["BPH", "PCA"]
    report: Dict = {"data_dir": os.path.abspath(data_dir), "types": {}, "ok": True}
    if not os.path.isdir(data_dir):
        report["ok"] = False
        report["error"] = "data_dir does not exist"
        return report
    for dt in data_types:
        entry: Dict = {"modalities": {}, "labels": 0}
        for m in DEFAULT_MODALITIES:
            d = os.path.join(data_dir, "BPH-PCA", dt, m)
            entry["modalities"][m] = (
                len([f for f in os.listdir(d) if not f.startswith(".")]) if os.path.isdir(d) else None
            )
        lab = os.path.join(data_dir, "BPH-PCA", LABEL_DIR, dt)
        entry["labels"] = (
            len([f for f in os.listdir(lab) if not f.startswith(".")]) if os.path.isdir(lab) else None
        )
        entry["present"] = entry["labels"] is not None and any(
            v for v in entry["modalities"].values() if v
        )
        report["types"][dt] = entry
    if not any(t["present"] for t in report["types"].values()):
        report["ok"] = False
    return report


def check_checkpoints(save_dir: str) -> Dict:
    out: Dict = {"save_dir": os.path.abspath(save_dir), "checkpoints": []}
    if os.path.isdir(save_dir):
        for name in sorted(os.listdir(save_dir)):
            if name.endswith(CHECKPOINT_EXTS) and os.path.isfile(os.path.join(save_dir, name)):
                out["checkpoints"].append(name)
    out["count"] = len(out["checkpoints"])
    return out


def check_package_files(root: str) -> Dict:
    required = [
        "pcmseg_tpu_torch/__init__.py",
        "pcmseg_tpu_torch/models/unet3d.py",
        "pcmseg_tpu_torch/ops/losses.py",
        "pcmseg_tpu_torch/ops/kernels/build.py",
        "pcmseg_tpu_torch/csrc/conv3x3x3.cu",
        "pcmseg_tpu_torch/csrc/conv3x3_dw.cu",
        "pcmseg_tpu_torch/data/dataset.py",
        "pcmseg_tpu_torch/train/trainer.py",
        "pcmseg_tpu_torch/infer/predict.py",
        "chip_smoke.py",
    ]
    out = {"root": os.path.abspath(root), "missing": [], "ok": True}
    for rel in required:
        if not os.path.exists(os.path.join(root, rel)):
            out["missing"].append(rel)
    out["ok"] = not out["missing"]
    return out


def generate_report(
    data_dir: str = "data",
    save_dir: str = "checkpoints",
    root: Optional[str] = None,
    output_path: Optional[str] = "project_check_report.json",
    device: str = "cuda",
) -> Dict:
    root = root or os.getcwd()
    report = {
        "dependencies": check_dependencies(),
        "devices": check_devices(device),
        "data": check_data_directory(data_dir),
        "checkpoints": check_checkpoints(save_dir),
        "files": check_package_files(root),
    }
    report["ok"] = bool(
        report["dependencies"]["ok"] and report["devices"]["ok"] and report["files"]["ok"]
    )
    if output_path:
        write_json(output_path, report)
    return report
