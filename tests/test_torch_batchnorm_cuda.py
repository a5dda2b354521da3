"""The training BatchNorm + ReLU kernels (``csrc/batchnorm_relu.cu`` through
``ops/kernels/batchnorm.py``) on the card, against the plain version and
float64, at every (voxels, C) of the 128³ base-64 model's five levels and a
tensor-parallel shard's width, in bf16, fp16 and fp32.

Every test needs an NVIDIA GPU and skips without one. The file imports no
JAX; on a machine that has only PyTorch, skip the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batchnorm_cuda.py
"""

import threading

import pytest
import torch

from pcmseg_tpu_torch.models.unet3d import BatchNorm, UNet3D
from pcmseg_tpu_torch.ops.kernels import batchnorm
from pcmseg_tpu_torch.parallel.collectives import LocalGroup

pytestmark = pytest.mark.cuda

EPS = 1e-5
# (spatial side, C) of the 18 BatchNorm layers at 128^3, base 64, one level
# each, and level 0 at one of 2 tensor-parallel shards
SHAPES = [(128, 64), (64, 128), (32, 256), (16, 512), (8, 1024), (128, 32)]
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, side, c, dtype, seed):
    """A conv output's like (a per-channel offset and scale), γ, β, dy."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, side, side, side, c), generator=g, device=device)
    x = x * (torch.rand(c, generator=g, device=device) * 2 + 0.2) + torch.randn(c, generator=g, device=device)
    gamma = torch.rand(c, generator=g, device=device) + 0.5
    beta = torch.randn(c, generator=g, device=device) * 0.3
    dy = torch.randn(x.shape, generator=g, device=device) * 1e-2
    return x.to(dtype), gamma, beta, dy.to(dtype)


def _module(gamma, beta):
    bn = BatchNorm(gamma.numel(), relu=True).to(gamma.device).train()
    with torch.no_grad():
        bn.weight.copy_(gamma)
        bn.bias.copy_(beta)
    return bn


def _run(bn, x, dy):
    """y, dx, dγ, dβ of ``bn`` on x with cotangent dy."""
    bn.zero_grad()
    xin = x.clone().requires_grad_()
    y = bn(xin)
    y.backward(dy)
    return y.detach(), xin.grad, bn.weight.grad.clone(), bn.bias.grad.clone()


def _plain_backward(x, gamma, beta, dy):
    """The plain BatchNorm's dx, dγ, dβ of the cotangent dy (already masked)."""
    xin, w, b = x.clone().requires_grad_(), gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    batchnorm.BatchNormTrain.apply(xin, w, b, EPS)[0].backward(dy)
    return xin.grad, w.grad, b.grad


def _errs(got, want):
    d = (got.double() - want).abs()
    return float(d.max()), float(d.square().mean().sqrt())


def _near(got, want, rel):
    want = want.double()
    return bool(((got.double() - want).abs() <= rel * (want.abs() + 1e-2 * want.abs().max())).all())


class _Ctx:
    """What an autograd Function's static methods use of their context, to
    run a forward and its backward on a thread without the autograd engine:
    on CUDA the engine runs every caller's backward on one device thread,
    where two ranks' all-reduces would wait for each other."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors

    def mark_non_differentiable(self, *tensors):
        pass


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("side,c", SHAPES, ids=[f"{s}^3x{c}" for s, c in SHAPES])
def test_kernels_match_plain_and_float64(cuda_device, side, c, dtype):
    x, gamma, beta, dy = _case(cuda_device, side, c, dtype, seed=side * c)
    kern, plain = _module(gamma, beta), _module(gamma, beta)  # the running statistics each path moves

    def kernel_run():
        xin, w, b = x.clone().requires_grad_(), gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        y, mean, unbiased = batchnorm.batchnorm_train(xin, w, b, EPS, relu=True, running=kern)
        y.backward(dy)
        return y.detach(), mean, unbiased, xin.grad, w.grad, b.grad

    before = batchnorm.launches
    y, mean, unbiased, dx, dg, db = kernel_run()
    torch.cuda.synchronize()
    assert batchnorm.launches == before + 4
    mask = y > 0
    # the plain forward (its running statistics too), and its backward on the kernel's mask
    y_p, mean_p, unbiased_p = batchnorm.batchnorm_train_reference(x, gamma, beta, EPS, relu=True, running=plain)
    dx_p, dg_p, db_p = _plain_backward(x, gamma, beta, dy * mask)
    flips = float((mask != (y_p > 0)).double().mean())
    # float64 of the same inputs, on the same mask
    x64 = x.double().requires_grad_()
    g64, b64 = gamma.double().requires_grad_(), beta.double().requires_grad_()
    z64, mean64, var64 = batchnorm.BatchNormTrain.apply(x64, g64, b64, EPS)
    z64.backward(dy.double() * mask)
    y64 = torch.relu(z64.detach())
    n = x.numel() // c
    pairs = {"y": (y, y_p, y64), "dx": (dx, dx_p, x64.grad), "dgamma": (dg, dg_p, g64.grad),
             "dbeta": (db, db_p, b64.grad), "mean": (mean, mean_p, mean64),
             "unbiased": (unbiased, unbiased_p, var64 * (n / (n - 1)))}
    errs = {k: (_errs(a, w), _errs(b, w)) for k, (a, b, w) in pairs.items()}
    # ReLU's mask against float64's rounded to the dtype: the plain apply
    # rounds mult, the product and the sum, so it flips elements near 0
    exact = y64.to(dtype) > 0
    flips_k, flips_p = (float((m != exact).double().mean()) for m in (mask, y_p > 0))
    print(f"{side}^3 x {c} {dtype}: mask flips from float64 kernel {flips_k:.2e} plain {flips_p:.2e}, kernel "
          f"against plain {flips:.2e}; (max, rms) error from float64, kernel / plain: {errs}")
    assert flips_k <= flips_p
    # no further from float64 than the plain version, as the largest and the
    # rms error; so within twice the plain version's own error of it
    for k, ((k_max, k_rms), (p_max, p_rms)) in errs.items():
        assert k_max <= p_max and k_rms <= p_rms, (k, errs[k])
        got, ref, _ = pairs[k]
        assert float((got.double() - ref.double()).abs().max()) <= 2 * p_max, k
    # the running statistics: the plain update of the kernel's own mean and
    # unbiased variance, bit for bit (from 0 and 1)
    assert torch.equal(kern.running_mean, 0.9 * torch.zeros_like(mean) + 0.1 * mean)
    assert torch.equal(kern.running_var, 0.9 * torch.ones_like(unbiased) + 0.1 * unbiased)
    assert int(kern.num_batches_tracked) == int(plain.num_batches_tracked) == 1
    # the same bits a second time
    again = kernel_run()
    assert all(torch.equal(a, b) for a, b in zip((y, mean, unbiased, dx, dg, db), again))


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_relu_mask_is_the_rounded_outputs(cuda_device, dtype):
    """dx with the ReLU inside equals the norm's dx (no ReLU) of dy masked by
    y > 0, bit for bit, with a channel whose pre-activations are positive
    but round to 0 in 16 bits (β below half the smallest subnormal)."""
    c = 64
    x, gamma, beta, dy = _case(cuda_device, 32, c, dtype, seed=11)
    tiny = {torch.float16: (1e-12, 1e-8), torch.bfloat16: (1e-44, 3e-41), torch.float32: (1e-3, 1e-2)}[dtype]
    gamma[0], beta[0] = tiny
    y, dx, dg, db = _run(_module(gamma, beta), x, dy)
    linear = _module(gamma, beta)
    linear.relu = False
    z, dx_lin, dg_lin, db_lin = _run(linear, x, dy * (y > 0))
    if dtype != torch.float32:  # every pre-activation of channel 0 is positive and rounds to 0
        assert bool((y[..., 0] == 0).all())
    assert torch.equal(y, torch.relu(z))
    assert torch.equal(dx, dx_lin) and torch.equal(dg, dg_lin) and torch.equal(db, db_lin)


def test_synchronised_ranks_match_one_rank(cuda_device):
    """Two ranks (threads of a LocalGroup on the card), each half of a batch
    of 2, against one rank over the whole batch."""
    c, side = 128, 32
    x, gamma, beta, dy = _case(cuda_device, side, c, torch.bfloat16, seed=5)
    x2 = torch.cat([x, x.flip(1) * 0.5 + 0.25])
    dy2 = torch.cat([dy, dy.flip(2)])
    whole = _run(_module(gamma, beta), x2, dy2)
    group, n = LocalGroup(2), x2.numel() // c
    got = [None, None]

    def rank(r):
        try:
            ctx = _Ctx()
            fn = batchnorm._BatchNormKernels
            y, _, _ = fn.forward(ctx, x2[r:r + 1].contiguous(), gamma, beta, EPS, group.member(r), n, True, None)
            got[r] = (y, *fn.backward(ctx, dy2[r:r + 1].contiguous(), None, None)[:3])
        except BaseException:
            group.abort()
            raise

    before = batchnorm.launches
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert batchnorm.launches == before + 8
    y = torch.cat([got[0][0], got[1][0]])
    dx = torch.cat([got[0][1], got[1][1]])
    assert _near(y, whole[0], 2 ** -7) and _near(dx, whole[1], 2 ** -7)
    # dγ and dβ are each rank's sums: the gradient all-reduce adds them
    torch.testing.assert_close(got[0][2] + got[1][2], whole[2], rtol=1e-5, atol=1e-5 * float(whole[2].abs().max()))
    torch.testing.assert_close(got[0][3] + got[1][3], whole[3], rtol=1e-5, atol=1e-5 * float(whole[3].abs().max()))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("deferred", [False, True], ids=["moved", "stat_log"])
def test_model_launches_the_kernels(cuda_device, remat, deferred):
    """A training forward and backward of the model: 4 launches a BatchNorm
    layer (6 with remat, which recomputes the forward), each layer's running
    statistics moved once or logged; an eval forward launches none."""
    model = UNet3D(base_features=8, remat=remat, generator=torch.Generator().manual_seed(0)).to(cuda_device).train()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.stat_log = [] if deferred else None
    x = torch.randn((1, 32, 32, 32, 5), device=cuda_device)
    before = batchnorm.launches
    (model(x) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert batchnorm.launches - before == len(norms) * (6 if remat else 4) and len(norms) == 18
    assert all(int(m.num_batches_tracked) == (0 if deferred else 1) for m in norms)
    assert all(len(m.stat_log) == 1 for m in norms) if deferred else True
    model.eval()
    before = batchnorm.launches
    with torch.no_grad():
        model(x)
    assert batchnorm.launches == before


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda_device):
    bn = BatchNorm(64, relu=True).to(cuda_device).train()
    with pytest.raises(TypeError):
        bn(torch.randn((1, 4, 4, 4, 64), dtype=torch.float64, device=cuda_device))
    bn = BatchNorm(36, relu=True).to(cuda_device).train()
    with pytest.raises(ValueError):
        bn(torch.randn((1, 4, 4, 4, 36), dtype=torch.bfloat16, device=cuda_device))
