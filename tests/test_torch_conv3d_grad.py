"""Port's conv weight gradient (ops/kernels/conv3d_grad.py) and training conv
(ops/hybrid_conv.py) against the JAX package on the CPU.

The JAX side runs the Pallas ``conv3x3_dw`` in interpret mode and the
``conv3x3_hybrid(dw_impl='pallas')`` custom VJP, as
``tests/test_pallas_grad.py`` does; the port runs the wrappers' plain
versions (CPU tensors). Inputs come from numpy with a seed, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.ops import hybrid_conv as jax_hybrid
from pcmseg_tpu.ops.pallas import conv3d_grad as jax_dw
from pcmseg_tpu_torch.ops import hybrid_conv
from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

# fp32 sums of the same products in another order
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "n,spatial,ci,co",
    [
        (1, (4, 6, 8), 5, 8),  # the input conv's Ci = 5
        (2, (5, 4, 6), 8, 16),
        (1, (6, 6, 6), 16, 8),
        (2, (3, 7, 5), 16, 24),
    ],
)
def test_dw_plain_matches_pallas_interpret(n, spatial, ci, co):
    x = _rand((n, *spatial, ci), seed=ci)
    dy = _rand((n, *spatial, co), seed=co + 100)
    want = np.asarray(jax_dw.conv3x3_dw(jnp.asarray(x), jnp.asarray(dy), interpret=True))
    got = conv3d_grad.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, 3, ci, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ci", [5, 40])
def test_dw_channel_padding_matches_jax_reference(ci):
    """What the CUDA wrapper does: dW of x's channels zero-padded to
    ci_pad(Ci), here through the plain version, sliced back to the real
    channels, equals JAX's conv3x3_dw_reference; the padded rows are 0."""
    x = _rand((1, 5, 4, 6, ci), seed=ci)
    dy = _rand((1, 5, 4, 6, 16), seed=7)
    full = conv3d_grad.conv3x3_dw_reference(conv3d.pad_channels(torch.from_numpy(x)), torch.from_numpy(dy))
    assert tuple(full.shape) == (3, 3, 3, conv3d.ci_pad(ci), 16) and not full[:, :, :, ci:].any()
    want = np.asarray(jax_dw.conv3x3_dw_reference(jnp.asarray(x), jnp.asarray(dy)))
    np.testing.assert_allclose(full[:, :, :, :ci].numpy(), want, rtol=RTOL, atol=ATOL)


def test_dw_plain_on_cpu_launches_no_kernel():
    before = conv3d_grad.launches
    conv3d_grad.conv3x3_dw(torch.zeros(1, 4, 4, 4, 8), torch.zeros(1, 4, 4, 4, 8))
    assert conv3d_grad.launches == before


def test_conv_function_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 3, 4, 5, 8), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((8, 8, 3, 3, 3), generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn((8,), generator=g, dtype=torch.float64, requires_grad=True)

    def f(x, w, b):
        return hybrid_conv.conv3x3(x, w, b, conv3d.pack_weight(w.detach()))

    assert torch.autograd.gradcheck(f, (x, w, b))


@pytest.mark.parametrize("ci,co", [(8, 16), (16, 8)])
def test_conv_function_grads_match_jax_hybrid_pallas(monkeypatch, ci, co):
    """dx, dW and db of the Function against jax.grad through
    conv3x3_hybrid(dw_impl='pallas') (Pallas dW in interpret mode)."""
    orig = jax_dw.conv3x3_dw
    monkeypatch.setattr(jax_dw, "conv3x3_dw", lambda x, dy, interpret=False: orig(x, dy, interpret=True))
    x = _rand((2, 6, 5, 7, ci), seed=1)
    w = _rand((3, 3, 3, ci, co), seed=2, scale=0.1)  # DHWIO
    b = _rand((co,), seed=3)
    dy = _rand((2, 6, 5, 7, co), seed=4)

    def loss(x, w, b):
        y = jax_hybrid.conv3x3_hybrid(x, w, "pallas") + b
        return jnp.sum(y * dy)

    want_y = np.asarray(jax_hybrid.conv3x3_hybrid(jnp.asarray(x), jnp.asarray(w), "pallas") + b)
    dx_j, dw_j, db_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = hybrid_conv.conv3x3(xt, wt, bt, conv3d.pack_weight(wt.detach()))
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        wt.grad.numpy(), np.asarray(dw_j).transpose(4, 3, 0, 1, 2), rtol=RTOL, atol=1e-3
    )
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), rtol=RTOL, atol=1e-3)


def test_conv_function_matches_its_plain_version():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 5, 6, 4, 8), generator=g, requires_grad=True)
    w = torch.randn((16, 8, 3, 3, 3), generator=g, requires_grad=True)
    b = torch.randn((16,), generator=g, requires_grad=True)
    dy = torch.randn((1, 5, 6, 4, 16), generator=g)
    grads = []
    for f in (hybrid_conv.conv3x3, hybrid_conv.conv3x3_plain):
        y = f(x, w, b, conv3d.pack_weight(w.detach()))
        grads.append((y.detach(), *torch.autograd.grad((y * dy).sum(), (x, w, b))))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def test_input_conv_needs_no_dx():
    """The image needs no gradient: the input conv (Ci = 5) skips dx."""
    x = torch.randn((1, 4, 4, 4, 5))
    w = torch.randn((8, 5, 3, 3, 3), requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y = hybrid_conv.conv3x3(x, w, b, conv3d.pack_weight(w.detach()))
    y.sum().backward()
    assert x.grad is None and w.grad is not None and torch.equal(b.grad, torch.full((8,), 64.0))
