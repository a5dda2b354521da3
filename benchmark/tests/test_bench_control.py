"""The control comes out not correct: the reference put in the program's
place, computed in int8 (a precision below the configurations' bf16:
``reference/unet3d.py`` ``Precision``), at each cell's own size on the
card, on three seeds, against the cell's own limits. Needs the card:
skips without one."""

import pytest
import torch

from benchmark import calibrate
from benchmark.lib import harness

CELLS = ["bn_train_b4", "bn_serve_ens5_tta_backlog"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    for seed in (2147484001, 2147484002, 2147484003):
        cell = harness.load_cell(name, seed, 0.0, False)
        limits = cell.limits
        if cell.traffic["driver"] == "train":
            control = calibrate.train_readings(cell, "faults")["control"]
            assert any(control[k] > limits[k] for k in control if k in limits), (seed, control, limits)
        else:
            control = calibrate.serve_readings(cell, "faults")["control"]
            assert control > limits["mask_gap"], (seed, control, limits)
