"""The nnU-Net cell's pieces on the CPU: ``lib/nnunet_shapes.py``'s conv list
and operations against the reference's own calls at a small plan; the
driver's difference-based gaps on toy tensors; the training readers on
the driver's readings; and the driver itself at a small plan in float32, a
sound run correct and each planted fault not, by the cell's own limits."""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from benchmark import calibrate_nnunet
from benchmark.drivers import train, train_nnunet
from benchmark.lib import flops, harness, nnunet_shapes
from benchmark.reference import nnunet as ref

FEATURES = (4, 8, 16, 16)


class _Calls(TorchFunctionMode):
    """Records every conv and transposed conv the reference calls: (kind,
    Ci, Co, stride, output voxels of one sample, output operations)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (F.conv3d, F.conv_transpose3d):
            x, w = args[0], args[1]
            stride = (kwargs or {}).get("stride", args[3] if len(args) > 3 else 1)
            voxels = math.prod(out.shape[2:])
            if func is F.conv3d:
                ci, co, k = w.shape[1], w.shape[0], math.prod(w.shape[2:])
                flop = 2 * k * ci * co * voxels
            else:
                ci, co = w.shape[0], w.shape[1]
                flop = 2 * ci * co * voxels  # each output voxel takes one tap
            kind = "up" if func is F.conv_transpose3d else ("head" if w.shape[-1] == 1 else "conv")
            self.calls.append((kind, ci, co, stride, voxels, flop))
        return out


@pytest.mark.parametrize("size", [(32, 32, 32), (16, 24, 32)])
def test_conv_list_and_operations_match_the_reference(size):
    cfg = dict(n_modalities=5, n_classes=3, nnunet_features=FEATURES)
    sd = ref.init_state(cfg, 1, "cpu")
    mode = _Calls()
    with mode, torch.no_grad():
        ref.forward(sd, torch.rand((1, 5, *size)), deep_supervision=True)
    convs = [(ci, co, s, v) for kind, ci, co, s, v, _ in mode.calls if kind == "conv"]
    want = [(c.ci, c.co, s, c.voxels) for c, s in nnunet_shapes.convs(FEATURES, 5, size)]
    assert convs == want
    assert [(c.ci, c.co, c.voxels) for c in nnunet_shapes.b1_convs(FEATURES, 5, size)] == \
        [(ci, co, v) for ci, co, s, v in convs if s == 1]
    assert sum(f for *_, f in mode.calls) == nnunet_shapes.forward_flop(FEATURES, 5, 3, size)
    heads = [v for kind, _, _, _, v, _ in mode.calls if kind == "head"]
    assert len(heads) == len(nnunet_shapes.head_stages(len(FEATURES))) == 2


def test_published_plan_counts():
    """The published plan's arithmetic: 449.8 GMAC of stride-1 convs, 26.7 strided,
    0.969 TFLOP a forward, 5.8 a step of 2."""
    f, size = (32, 64, 128, 256, 320, 320), (128, 128, 128)
    cs = nnunet_shapes.convs(f, 5, size)
    assert round(sum(c.flop for c, s in cs if s == 1) / 2e9, 1) == 449.8
    assert round(sum(c.flop for c, s in cs if s == 2) / 2e9, 1) == 26.7
    assert round(nnunet_shapes.forward_flop(f, 5, 3, size) / 1e12, 3) == 0.969
    assert round(nnunet_shapes.train_flop(f, 5, 3, size, 2) / 1e12, 1) == 5.8
    assert len(nnunet_shapes.b1_convs(f, 5, size)) == 17
    assert nnunet_shapes.b1_bound_s(f, 5, size) > sum(flops.conv_seconds(c, "fwd")
                                                      for c in nnunet_shapes.b1_convs(f, 5, size))


def test_difference_gaps_see_a_turned_gradient_that_norms_do_not():
    """Identical gradients read 0. Half a batch on toy tensors: two samples'
    gradients a and b, the mean (a + b)/2 the reference's, the program's a
    alone rescaled to the mean's norm: the difference of norms reads 0,
    the norm of the difference ~1 (0.77 for a, b at 90 degrees)."""
    g = torch.Generator().manual_seed(0)
    a = {k: torch.randn(2000, generator=g) for k in ("w1", "w2", "w3")}
    b = {k: torch.randn(v.shape, generator=g) for k, v in a.items()}
    mean = {k: (a[k] + b[k]) / 2 for k in a}
    assert max(train_nnunet.leaf_gaps(mean, mean).values()) == 0.0
    half = {k: a[k] * (mean[k].norm() / a[k].norm()) for k in a}
    norm_rule = train.leaf_gaps({k: float(v.norm()) for k, v in half.items()},
                                {k: float(v.norm()) for k, v in mean.items()}, list(a))
    assert max(norm_rule.values()) < 1e-6
    gaps = train_nnunet.leaf_gaps(half, mean)
    assert all(0.6 < v < 0.95 for v in gaps.values()), gaps
    assert train_nnunet.leaf_gaps({}, mean)["w1"] == 1.0  # a leaf the program lacks


def test_the_train_readers_read_the_nnunet_driver():
    """The cell shares the U-Net cell's training metrics: on the driver's
    readings of an untraced tiny run ``step_mfu.train`` reads the window's
    operations, and every reader of the trace or the program's spans
    returns None (the traced run fills them on the card)."""
    out = harness.driver(tiny(0.3)).run(tiny(0.3))
    r = out.readings
    assert set(r.work) == {"flop", "b1_bound_s", "b2_bound_s"} and r.counters["steps"] >= 1
    assert harness._metric_reader("step_mfu.train")(r) > 0
    for name in ("b1_roofline.train", "b2_roofline.train", "glue_device_ms.train", "idle_share.train",
                 "dispatch_ms.train"):
        assert harness._metric_reader(name)(r) is None, name


def tiny(seconds=1.0):
    cell = harness.load_cell("nnunet_train_b2", 2 ** 31 + 29, seconds, False)
    cell.config = dict(cell.config, nnunet_features=list(FEATURES), target_size=[32, 32, 32],
                       compute_dtype="float32")
    cell.traffic = dict(cell.traffic, cohort=8)
    cell.device = "cpu"
    return cell


def judged(cell):
    out = harness.driver(cell).run(cell)
    return out.failed == 0 and all(c.ok for c in out.checks), {c.name: c.value for c in out.checks}


def test_sound_run_is_correct():
    correct, found = judged(tiny())
    # fp32 on both sides; 3 Nesterov steps move the 4³ stages by ~1e-3, where
    # the two orders of the sums part by 1.5% (measured)
    assert correct and found["grad_gap"] < 1e-3 and found["change_gap"] < 0.05, found


@pytest.mark.parametrize("fault", ["half_batch", "slope0", "groupnorm8"])
def test_planted_fault_is_not_correct(fault):
    with calibrate_nnunet.planted(fault):
        correct, found = judged(tiny(0.3))
    assert not correct, found
