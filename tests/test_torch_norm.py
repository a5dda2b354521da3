"""Port's training-mode BatchNorm and block remat (models/unet3d.py) against
the JAX package's ``TPUBatchNorm`` (models/norm.py), float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.models.norm import TPUBatchNorm
from pcmseg_tpu_torch.models.unet3d import BatchNorm, UNet3D

C = 6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(2, 4, 5, 3, C)) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    dy = rng.normal(size=xs[0].shape).astype(np.float32)
    bn = TPUBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    variables = {
        "params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)},
    }
    outs, stats = [], variables["batch_stats"]
    for x in xs:
        y, mut = bn.apply({**variables, "batch_stats": stats}, x, mutable=["batch_stats"])
        outs.append(np.asarray(y))
        stats = mut["batch_stats"]

    def loss(x, p):
        y, _ = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, x, mutable=["batch_stats"])
        return jnp.sum(y * dy)

    dx, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xs[0]), variables["params"])
    want = {
        "outs": outs,
        "mean": np.asarray(stats["mean"]),
        "var": np.asarray(stats["var"]),
        "dx": np.asarray(dx),
        "dscale": np.asarray(dp["scale"]),
        "dbias": np.asarray(dp["bias"]),
    }
    return xs, scale, bias, dy, want


def _port_bn(scale, bias):
    bn = BatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn


def test_train_mode_output_and_running_stats_match_jax(case):
    xs, scale, bias, _, want = case
    bn = _port_bn(scale, bias)
    for x, y_want in zip(xs, want["outs"]):
        with torch.no_grad():
            y = bn(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), y_want, rtol=1e-5, atol=1e-5)
    # momentum 0.1 toward the batch mean and the unbiased batch variance
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"], rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2


def test_train_mode_gradients_match_jax(case):
    xs, scale, bias, dy, want = case
    bn = _port_bn(scale, bias)
    x = torch.from_numpy(xs[0]).requires_grad_()
    (bn(x) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), want["dscale"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), want["dbias"], rtol=1e-4, atol=1e-4)


def test_train_mode_gradcheck_float64():
    bn = BatchNorm(3).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    x = torch.randn((2, 3, 2, 3, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: bn(x), (x,))


def test_eval_mode_uses_running_stats():
    bn = BatchNorm(C).eval()
    x = torch.randn(1, 2, 2, 2, C)
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(4.0)
        torch.testing.assert_close(bn(x), (x - 0.5) / (4.0 + 1e-5) ** 0.5)
    assert int(bn.num_batches_tracked) == 0


def test_remat_gives_the_same_gradients_and_running_stats():
    """Block remat recomputes each block's forward in the backward; the BN
    running statistics still move once per forward, and the gradients and
    statistics equal those without remat."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 16, 16, 5)).astype(np.float32))
    results = []
    for remat in (False, True):
        model = UNet3D(base_features=8, dtype=torch.float32, remat=remat,
                       generator=torch.Generator().manual_seed(0)).train()
        for _ in range(2):
            model.zero_grad()
            (model(x) ** 2).mean().backward()
        results.append(model)
    plain, remat = results
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-5, atol=1e-7, msg=name)
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    assert int(remat.inc.conv[1].num_batches_tracked) == 2
