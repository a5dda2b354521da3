"""JSON artifact helpers — field-compatible with the reference's outputs.

The port's copy of ``pcmseg_tpu/utils/artifacts.py``.

Artifacts produced across the framework (writers live with their owners,
formats documented here):
  * cv_results.json        — {'config', 'fold_results': [{'fold',
                              'best_val_loss', 'epochs_trained'}...],
                              'summary': {'mean_val_loss', 'std_val_loss',
                              'total_folds'}} (train_bph_optimized.py:437-458)
  * fold_{k}_history.json  — {'train_loss': [...], 'val_loss': [...]}
                              (train_bph_cv.py:227,254-260)
  * validation_results.json— {'timestamp', 'avg_dice', 'avg_iou',
                              'case_count', 'case_results'}
                              (validate_model.py:260-273)
  * project_check_report.json — see pcmseg_tpu_torch/utils/check.py
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _sanitize(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:  # noqa: BLE001
            return str(obj)
    return obj


def write_json(path: str, payload: Any) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(_sanitize(payload), f, indent=2, ensure_ascii=False)
    return path


def read_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)
