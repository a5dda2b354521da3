"""The training BatchNorm with its ReLU as one layer (``ops/kernels/batchnorm.py``)
on the CPU: its plain path against BatchNorm then ``nn.ReLU`` as separate
modules, the model against the same model laid out with separate ReLUs
(remat and the deferred running statistics too), the reference layout's
state dict, the BN fold, and the kernels' argument checks."""

import pytest
import torch
from torch import nn

from pcmseg_tpu_torch.infer.fold_bn import fold_batchnorm
from pcmseg_tpu_torch.models.unet3d import BatchNorm, DoubleConv, UNet3D
from pcmseg_tpu_torch.ops.kernels import batchnorm

C = 6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(dtype=torch.float32):
    """A BatchNorm with its ReLU inside, and the same BatchNorm followed by an
    ``nn.ReLU`` module, from one seeded state."""
    g = torch.Generator().manual_seed(0)
    fused = BatchNorm(C, relu=True).train()
    with torch.no_grad():
        fused.weight.copy_(torch.rand(C, generator=g) + 0.5)
        fused.bias.copy_(torch.randn(C, generator=g) * 0.3)
    apart = BatchNorm(C).train()
    apart.load_state_dict(fused.state_dict())
    return fused.to(dtype), nn.Sequential(apart, nn.ReLU()).to(dtype)


def _input(dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, 4, 5, 3, C), generator=g) * 2 + 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=["fp32", "bf16", "fp64"])
def test_plain_path_is_batchnorm_then_relu(dtype):
    fused, apart = _pair(dtype)
    g = torch.Generator().manual_seed(2)
    dy = torch.randn((2, 4, 5, 3, C), generator=g).to(dtype)
    outs = []
    for model in (fused, apart):
        x = _input(dtype).requires_grad_()
        y = model(x)
        y.backward(dy)
        bn = model if isinstance(model, BatchNorm) else model[0]
        outs.append([y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var,
                     bn.num_batches_tracked])
    assert bool((outs[0][0] == 0).any()) and bool((outs[0][0] > 0).any())
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_plain_path_defers_the_running_statistics_to_the_log():
    fused, apart = _pair()
    logs = []
    for model in (fused, apart):
        bn = model if isinstance(model, BatchNorm) else model[0]
        bn.stat_log = []
        model(_input(torch.float32))
        logs.append(bn.stat_log)
        assert torch.equal(bn.running_mean, torch.zeros(C)) and int(bn.num_batches_tracked) == 0
    (m1, v1), (m2, v2) = logs[0][0], logs[1][0]
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_eval_applies_the_relu():
    fused, apart = _pair()
    with torch.no_grad():
        for bn in (fused, apart[0]):
            bn.running_mean.fill_(0.25)
            bn.running_var.fill_(2.0)
    fused.eval(), apart.eval()
    x = _input(torch.float32)
    with torch.no_grad():
        y = fused(x)
        assert torch.equal(y, apart(x)) and bool((y == 0).any())


def _unfused(model: UNet3D) -> UNet3D:
    """``model`` with every BatchNorm's ReLU back in its own ``nn.ReLU``
    module at the same index (the layout before the two ran as one)."""
    for m in model.modules():
        if isinstance(m, DoubleConv):
            for i in (1, 4):
                m.conv[i].relu = False
                m.conv[i + 1] = nn.ReLU()
    return model


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("deferred", [False, True], ids=["moved", "stat_log"])
def test_model_matches_the_layout_with_separate_relus(remat, deferred):
    x = torch.randn((2, 16, 16, 16, 5), generator=torch.Generator().manual_seed(3))
    models = []
    for split in (False, True):
        model = UNet3D(base_features=4, dtype=torch.float32, remat=remat,
                       generator=torch.Generator().manual_seed(0)).train()
        if split:
            model = _unfused(model)
        norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.stat_log = [] if deferred else None
        for _ in range(2):
            model.zero_grad()
            (model(x) ** 2).mean().backward()
        models.append((model, [m.stat_log for m in norms]))
    (fused, fused_logs), (split, split_logs) = models
    assert sum(isinstance(m, nn.ReLU) for m in fused.modules()) == 0
    for (name, a), b in zip(fused.named_parameters(), split.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), b in zip(fused.named_buffers(), split.buffers()):
        assert torch.equal(a, b), name
    for a, b in zip(fused_logs, split_logs):
        assert (a is None and b is None) or all(torch.equal(p, q) for s, t in zip(a, b) for p, q in zip(s, t))
    # remat recomputes each block's forward; the statistics still move once a forward
    assert int(fused.inc.conv[1].num_batches_tracked) == (0 if deferred else 2)


class _ReferenceUNet(nn.Module):
    """The reference network's module layout (NCDHW stock modules, a ReLU at
    indices 2 and 5 of each double conv): only its state dict's keys and
    shapes are used."""

    def __init__(self, n_modalities=5, n_classes=1, f=4):
        super().__init__()

        def double(ci, co):
            seq = nn.Sequential(nn.Conv3d(ci, co, 3, padding=1), nn.BatchNorm3d(co), nn.ReLU(inplace=True),
                                nn.Conv3d(co, co, 3, padding=1), nn.BatchNorm3d(co), nn.ReLU(inplace=True))
            holder = nn.Module()
            holder.conv = seq
            return holder

        def down(ci, co):
            holder = nn.Module()
            holder.maxpool_conv = nn.Sequential(nn.MaxPool3d(2), double(ci, co))
            return holder

        def up(ci, co):
            holder = nn.Module()
            holder.up = nn.ConvTranspose3d(ci, co, 2, stride=2)
            holder.conv = double(2 * co, co)
            return holder

        self.inc = double(n_modalities, f)
        self.down1, self.down2, self.down3, self.down4 = (down(f, 2 * f), down(2 * f, 4 * f), down(4 * f, 8 * f),
                                                          down(8 * f, 16 * f))
        self.up1, self.up2, self.up3, self.up4 = (up(16 * f, 8 * f), up(8 * f, 4 * f), up(4 * f, 2 * f),
                                                  up(2 * f, f))
        self.outc = nn.Conv3d(f, n_classes, 1)


def test_reference_layout_state_dict_loads_strictly():
    ref = _ReferenceUNet().state_dict()
    model = UNet3D(base_features=4, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(ref, strict=True)
    mine = model.state_dict()
    assert list(mine) == list(ref)
    assert all(mine[k].shape == ref[k].shape for k in ref)
    _ReferenceUNet().load_state_dict(mine, strict=True)


def test_fold_bn_folds_the_fused_model():
    x = torch.randn((1, 16, 16, 16, 5), generator=torch.Generator().manual_seed(4))
    model = UNet3D(base_features=4, dtype=torch.float32, generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        for _ in range(3):  # running statistics away from (0, 1)
            model(x * 3 + 1)
    model.eval()
    folded = UNet3D(base_features=4, norm_layer="none", dtype=torch.float32)
    folded.load_state_dict(fold_batchnorm(model.state_dict()), strict=True)
    folded.eval()
    with torch.no_grad():
        want, got = model(x), folded(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_gradcheck_float64_with_relu():
    w, b = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64), torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    x = torch.randn((2, 3, 2, 3, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(5))

    def f(x, w, b):
        return batchnorm.batchnorm_train_reference(x, w, b, 1e-5, relu=True)[0]

    assert torch.autograd.gradcheck(f, (x.requires_grad_(), w.requires_grad_(), b.requires_grad_()))


def _meta_args(dtype=torch.bfloat16, c=64, shape=(1, 4, 4, 4)):
    x = torch.empty((*shape, c), dtype=dtype)
    return x, torch.ones(c), torch.zeros(c)


def test_kernel_args_taken():
    for dtype, c in ((torch.bfloat16, 64), (torch.float16, 8), (torch.float32, 4), (torch.float32, 1024)):
        x, w, b = _meta_args(dtype, c)
        batchnorm.check_kernel_args(x, w, b, BatchNorm(c))


@pytest.mark.parametrize("case", ["float64", "channels", "strided", "empty", "weight", "running", "too_wide"])
def test_kernel_args_refused(case):
    x, w, b = _meta_args()
    running = None
    if case == "float64":
        x = x.double()
    elif case == "channels":
        x, w, b = _meta_args(torch.bfloat16, 36)
    elif case == "strided":
        x = torch.empty((1, 4, 4, 4, 128), dtype=torch.bfloat16)[..., :64]
    elif case == "empty":
        x, w, b = _meta_args(shape=(0, 4, 4, 4))
    elif case == "weight":
        w = torch.ones(32)
    elif case == "running":
        running = BatchNorm(64).double()
    elif case == "too_wide":
        c = batchnorm.MAX_SLICES * batchnorm.SLICE_VECTORS * 8 + 8
        x, w, b = torch.empty((1, 1, 1, 1, c), dtype=torch.bfloat16), torch.ones(c), torch.zeros(c)
    with pytest.raises((TypeError, ValueError)):
        batchnorm.check_kernel_args(x, w, b, running)


def test_other_devices_are_refused():
    x = torch.empty((1, 2, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        batchnorm.batchnorm_train(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), 1e-5)


def test_cpu_calls_launch_nothing():
    before = batchnorm.launches
    fused, _ = _pair()
    fused(_input(torch.float32)).sum().backward()
    assert batchnorm.launches == before

