"""The 3xTF32 arithmetic of the port's fp32 conv kernels, on the CPU.

The fp32 kernels (``csrc/conv3x3x3_f32.cu``, ``csrc/conv3x3_dw_f32.cu``)
split every operand v into ``hi = tf32(v)`` and ``lo = tf32(v - hi)``
(``cvt.rna.tf32.f32``) and sum ``lo·hi + hi·lo + hi·hi`` on the tensor
cores. ``conv3d.tf32_split`` is that split in PyTorch (the wrapper splits
the packed weight with it); it is held here against an independent
float64 rounding. Then the 3xTF32 conv itself, emulated as three float64
convs of the split parts (exact products and sums, so only the split's
error is left), is held to the gate that ``chip_smoke.py``'s fp32_kernels
phase puts on the card's kernels: within FP32_MARGIN (2.0) times the plain
fp32 conv's error from float64, plus FP32_SLACK (1e-6) of max |float64|,
for the forward, dx and dW at base-4 shapes (the 5 -> 8 padded input conv,
a 32-channel output shard among them). The card's kernels add their own
fp32 sums to the split's error; this predicts the rest of the gate on the
CPU.
"""

import numpy as np
import pytest
import torch

from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

# chip_smoke.py's fp32_kernels gate
FP32_MARGIN = 2.0
FP32_SLACK = 1e-6


def _tf32_float64(a: np.ndarray) -> np.ndarray:
    """tf32(a) of finite normal fp32 values, computed apart from the bit
    arithmetic: the significand scaled to 11 bits, rounded half away from
    zero in float64."""
    a = a.astype(np.float64)
    _, e = np.frexp(a)  # |a| = m · 2^e, m in [0.5, 1)
    scaled = np.abs(a) * np.ldexp(1.0, 11 - e)  # in [2^10, 2^11)
    return np.sign(a) * np.ldexp(np.floor(scaled + 0.5), e - 11)


def test_tf32_split_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(200_000) * np.exp(rng.uniform(-20, 20, 200_000))).astype(np.float32)
    hi, lo = conv3d.tf32_split(torch.from_numpy(a))
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _tf32_float64(a))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # a - hi is exact in fp32, and lo its TF32 rounding
    np.testing.assert_array_equal(lo.numpy().astype(np.float64), _tf32_float64((a - hi.numpy()).astype(np.float32)))
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - a)
    assert np.all(err <= 2.0 ** -21 * np.abs(a.astype(np.float64)))


def test_tf32_split_ties_away_from_zero_and_keeps_specials():
    ulp = 2.0 ** -10  # a TF32 ulp at 1
    a = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 1 + ulp / 2 - 2.0 ** -23, 1 + ulp, 0.0, -0.0,
                      float("inf"), -float("inf"), float("nan")], dtype=torch.float32)
    hi, lo = conv3d.tf32_split(a)
    assert hi[:7].tolist() == [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 1 + ulp, 0.0, -0.0]
    assert torch.signbit(hi[6]) and hi[7] == float("inf") and hi[8] == -float("inf") and torch.isnan(hi[9])
    assert lo[:3].tolist() == [-ulp / 2, ulp / 2, -ulp / 2] and lo[4] == 0.0
    with pytest.raises(TypeError):
        conv3d.tf32_split(a.double())


def _split64(t: torch.Tensor):
    return [p.double() for p in conv3d.tf32_split(t)]


def _three_products(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn`` (bilinear) of fp32 ``a`` and ``b`` as 3xTF32 computes it:
    fn(a_lo, b_hi) + fn(a_hi, b_lo) + fn(a_hi, b_hi), each in float64."""
    a_hi, a_lo = _split64(a)
    b_hi, b_lo = _split64(b)
    return fn(a_lo, b_hi) + fn(a_hi, b_lo) + fn(a_hi, b_hi)


def _gate(emulated: torch.Tensor, plain: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    err = (emulated - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    bound = FP32_MARGIN * plain_err + FP32_SLACK * ref.abs().max().item()
    assert err <= bound, f"{what}: 3xTF32 {err:.4g} from float64, plain fp32 {plain_err:.4g}, bound {bound:.4g}"


# (Ci, Co, size) of base-4 layers at 16^3: the input conv (5 modalities,
# padded to 8), 4 -> 8, 8 -> 8, a 32-channel output shard of a 64-channel
# layer, and 64 -> 32 at the bottleneck's size
SHAPES = [(5, 4, 16), (4, 8, 16), (8, 8, 16), (32, 32, 8), (64, 32, 8)]


def _inputs(ci, co, size, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, size, size, size, ci)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((co, ci, 3, 3, 3)) * np.sqrt(2.0 / (27 * ci))).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((1, size, size, size, co)).astype(np.float32))
    return x, w, dy


@pytest.mark.parametrize("ci,co,size", SHAPES)
def test_three_tf32_forward_is_within_the_fp32_gate(ci, co, size):
    x, w, _ = _inputs(ci, co, size, seed=ci * 100 + co)
    packed = conv3d.pack_weight(w)
    ref = conv3d.conv3x3x3_reference(x.double(), packed.double(), None, False)
    plain = conv3d.conv3x3x3_reference(x, packed, None, False)
    emulated = _three_products(lambda a, b: conv3d.conv3x3x3_reference(a, b, None, False), x, packed)
    _gate(emulated, plain, ref, f"forward {ci}->{co}@{size}^3")


@pytest.mark.parametrize("ci,co,size", [s for s in SHAPES if s[0] % 8 == 0])
def test_three_tf32_dx_is_within_the_fp32_gate(ci, co, size):
    # dx of a Ci -> Co layer: B1 on dy (Co channels) with the flipped,
    # Ci<->Co-transposed weight
    _, w, dy = _inputs(ci, co, size, seed=ci * 100 + co + 1)
    packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1))
    ref = conv3d.conv3x3x3_reference(dy.double(), packed.double(), None, False)
    plain = conv3d.conv3x3x3_reference(dy, packed, None, False)
    emulated = _three_products(lambda a, b: conv3d.conv3x3x3_reference(a, b, None, False), dy, packed)
    _gate(emulated, plain, ref, f"dx {co}->{ci}@{size}^3")


@pytest.mark.parametrize("ci,co,size", SHAPES)
def test_three_tf32_weight_gradient_is_within_the_fp32_gate(ci, co, size):
    x, _, dy = _inputs(ci, co, size, seed=ci * 100 + co + 2)
    ref = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
    plain = conv3d_grad.conv3x3_dw_reference(x, dy)
    emulated = _three_products(conv3d_grad.conv3x3_dw_reference, x, dy)
    _gate(emulated, plain, ref, f"dW {ci}->{co}@{size}^3")
