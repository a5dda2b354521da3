"""The fp16 weight gradient's power-of-two scale of dy, on the CPU.

On an NVIDIA H100 the tensor cores align a sum's fp16 products as if a
subnormal operand were normal at 2^-14, so its leading zeros push bits out
of the sum, and the fp16 step's dy is nearly all zero or subnormal (no loss
scaling, in JAX as in the port): such dW elements lost up to 2.2e-5 of
their Σ|x·dy|. So the
fp16 entry point of ``csrc/conv3x3_dw.cu`` sums each tensor-core chain's
dy·2^k in place of dy, k = ``conv3d_grad.f16_scale_exponent`` of the
chain's max|dy| (``tests/test_torch_dw_scale.py``), and scales the chain's
sum by 2^-k. Both steps must be exact. Here, for one exponent over a tensor:

  * the exponent at every fp16 magnitude: max|dy|·2^k in [2^14, 2^15)
    where k > 0, never past 65504;
  * fp16 tensors holding ±0, subnormals, the largest normal and mixed
    signs (a grid of shares, and shares drawn from seeds): (dy·2^k)·2^-k is dy
    bit for bit (signed zeros included), nothing overflows, and a float64
    dW of the scaled dy, scaled back, is the float64 dW of dy bit for bit;
  * the port's fp16 dW (the plain version on CPU tensors) against the JAX
    kernel (``conv3x3_dw(..., interpret=True)``; ``conv3x3_dw_reference``
    refuses 16-bit inputs) on fp16 x and a dy with a set share of
    subnormals, both within 1e-6·Σ|x·dy| of float64 (each sums exact
    products in fp32, in its own order).

``chip_smoke.py``'s ``dw_sum`` phase holds the kernel itself to float64 on
such dy on the card, and the C exponent to this one at every magnitude.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.ops.pallas.conv3d_grad import conv3x3_dw as jax_dw
from pcmseg_tpu_torch.ops.kernels import conv3d_grad

F16_MAX = 65504.0
F16_NORMAL = 2.0**-14
F16_TINY = 2.0**-24
# each fp32 sum of exact fp16 products against float64, over Σ|x·dy|
SUM_BOUND = 1e-6


def _f16_magnitudes() -> torch.Tensor:
    """Every finite positive fp16 value, ascending."""
    return torch.arange(1, 0x7C00, dtype=torch.int32).to(torch.int16).view(torch.float16)


def _scaled(dy: torch.Tensor) -> tuple:
    """(dy·2^k in fp16, k) for k from max|dy|, as the kernel scales it."""
    k = conv3d_grad.f16_scale_exponent(float(dy.abs().max()))
    return (dy.double() * 2.0**k).to(torch.float16), k


def _dw64(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())


def test_scale_exponent_at_every_fp16_magnitude():
    values = _f16_magnitudes().double()
    ks = torch.tensor([conv3d_grad.f16_scale_exponent(v) for v in values.tolist()], dtype=torch.float64)
    top = values * torch.exp2(ks)
    assert float(top.max()) <= F16_MAX
    moved = ks > 0
    assert bool((top[moved] >= 2.0**14).all()) and bool((top[moved] < 2.0**15).all())
    assert bool((values[~moved] >= 2.0**14).all())  # no scale only where the largest |dy| is already high
    assert int(ks.max()) == 38 and conv3d_grad.f16_scale_exponent(F16_TINY) == 38
    for special in (0.0, math.inf, math.nan):
        assert conv3d_grad.f16_scale_exponent(special) == 0


def _check_exact(dy: torch.Tensor, x: torch.Tensor) -> None:
    scaled, k = _scaled(dy)
    assert bool(torch.isfinite(scaled).all())
    assert float(scaled.abs().max()) < 2.0**15 if k > 0 else torch.equal(scaled, dy)
    back = (scaled.double() * 2.0**-k).to(torch.float16)
    assert torch.equal(back.view(torch.int16), dy.view(torch.int16))  # signed zeros too
    assert torch.equal(_dw64(x, scaled) * 2.0**-k, _dw64(x, dy))


def _tensor(rng, shape, zero, sub, top, scale_exp) -> torch.Tensor:
    """fp16 values |normal|·2^-scale_exp with random signs, then shares of
    ±0, subnormals and ±65504 put in at random places."""
    v = np.abs(rng.standard_normal(shape)) * 2.0**-scale_exp * rng.choice([-1.0, 1.0], shape)
    pick = rng.random(shape)
    v = np.where(pick < zero, np.copysign(0.0, v), v)
    tiny = rng.integers(1, 1024, shape) * F16_TINY * np.sign(v)
    v = np.where((pick >= zero) & (pick < zero + sub), tiny, v)
    v = np.where((pick >= zero + sub) & (pick < zero + sub + top), np.copysign(F16_MAX, v), v)
    return torch.from_numpy(v).to(torch.float16)


@pytest.mark.parametrize("zero,sub,top,scale_exp", [
    (0.9, 0.1, 0.0, 22),     # as the fp16 step's dy at 8^3: all zero or subnormal
    (0.1, 0.4, 0.0, 0),      # 40% subnormal beside normal values
    (0.2, 0.2, 0.01, 0),     # the largest normal too: no scale
    (0.5, 0.0, 0.0, 20),     # small normal values only
    (1.0, 0.0, 0.0, 0),      # all ±0
])
def test_rescale_is_exact_on_a_grid(zero, sub, top, scale_exp):
    rng = np.random.default_rng(int(1e3 * zero + 1e2 * sub + 1e4 * top + scale_exp))
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 6, 8))).to(torch.float16)
    _check_exact(_tensor(rng, (1, 4, 5, 6, 16), zero, sub, top, scale_exp), x)


@pytest.mark.parametrize("seed", range(16))
def test_rescale_is_exact_on_drawn_tensors(seed):
    """Shares of ±0, subnormals and ±65504 and the scale of the rest drawn
    from the seed."""
    rng = np.random.default_rng(seed)
    zero, sub = rng.random(), rng.random()
    sub = min(sub, 1 - zero)
    top = min(rng.random() * 0.05, 1 - zero - sub) if seed % 2 else 0.0
    scale_exp = int(rng.integers(0, 41))
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 5, 8))).to(torch.float16)
    _check_exact(_tensor(rng, (1, 3, 4, 5, 8), zero, sub, top, scale_exp), x)


@pytest.mark.parametrize("sub_share", [0.1, 0.5, 1.0])
def test_port_fp16_dw_matches_the_jax_kernel_on_subnormal_dy(sub_share):
    """8³, Ci = Co = 16: x = |normal| in fp16, dy 50% zero, ``sub_share``
    of the rest subnormal and the other normal, mixed signs."""
    rng = np.random.default_rng(int(10 * sub_share))
    x = np.abs(rng.standard_normal((1, 8, 8, 8, 16))).astype(np.float16)
    mag = np.where(rng.random((1, 8, 8, 8, 16)) < sub_share, rng.integers(1, 1024, (1, 8, 8, 8, 16)) * F16_TINY,
                   np.abs(rng.standard_normal((1, 8, 8, 8, 16))) * 2.0**-10)
    dy = (mag * rng.choice([-1.0, 1.0], mag.shape) * (rng.random(mag.shape) < 0.5)).astype(np.float16)
    nonzero = dy != 0
    assert abs((np.abs(dy[nonzero]) < F16_NORMAL).mean() - sub_share) < 0.05
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy), interpret=True), np.float64)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = conv3d_grad.conv3x3_dw(xt, dyt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    exact = _dw64(xt, dyt).numpy()
    scale = conv3d_grad.conv3x3_dw_reference(xt.double(), dyt.double().abs()).numpy()
    scale = np.maximum(scale, 1e-300)
    assert (np.abs(got.double().numpy() - exact) / scale).max() <= SUM_BOUND
    assert (np.abs(want - exact) / scale).max() <= SUM_BOUND
