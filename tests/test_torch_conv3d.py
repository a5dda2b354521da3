"""Port's fused 3³ conv (pcmseg_tpu_torch/ops/kernels/conv3d.py) against the
Pallas kernel it replaces, and the weight packing the CUDA kernel reads.

On the CPU the port's wrapper runs its plain PyTorch version; the Pallas
kernel runs in interpret mode, as tests/test_pallas_conv.py runs it. The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcmseg_tpu.ops.pallas.conv3d import conv3x3x3 as pallas_conv3x3x3
from pcmseg_tpu.ops.pallas.conv3d import conv3x3x3_reference as jax_conv3x3x3_reference
from pcmseg_tpu_torch.ops.kernels import conv3d


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, spatial, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=spatial + (ci,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)  # DHWIO
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, w, b


def _port_weight(w_dhwio):
    """JAX (3, 3, 3, Ci, Co) → module layout (Co, Ci, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_dhwio, (4, 3, 0, 1, 2))))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("ci", [5, 8, 16])
def test_cpu_matches_pallas_interpret(ci, relu):
    x, w, b = _inputs(ci, (2, 4, 8, 6), ci, 16)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_conv3x3x3(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu, interpret=True
        )
    packed = conv3d.pack_weight(_port_weight(w))
    got = conv3d.conv3x3x3(torch.from_numpy(x), packed, torch.from_numpy(b), relu)
    assert got.shape == (2, 4, 8, 6, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cpu_no_bias_matches_pallas_interpret():
    x, w, _ = _inputs(1, (1, 4, 8, 8), 8, 8)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_conv3x3x3(jnp.asarray(x), jnp.asarray(w), None, relu=False, interpret=True)
    got = conv3d.conv3x3x3(torch.from_numpy(x), conv3d.pack_weight(_port_weight(w)), None, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_cpu_calls_do_not_count_launches():
    x, w, b = _inputs(2, (1, 4, 4, 4), 8, 8)
    before = conv3d.launches
    conv3d.conv3x3x3(torch.from_numpy(x), conv3d.pack_weight(_port_weight(w)), torch.from_numpy(b))
    assert conv3d.launches == before


@pytest.mark.parametrize("ci", [5, 8, 16, 64, 128, 256, 512, 1024])  # every Ci of the model and of its dx
def test_pack_weight_round_trips(ci):
    w = torch.randn(8, ci, 3, 3, 3, generator=torch.Generator().manual_seed(ci))
    packed = conv3d.pack_weight(w)
    cp = conv3d.ci_pad(ci)
    assert cp == (8 if ci <= 8 else -(-ci // 64) * 64) and cp >= ci
    assert packed.shape == (8, conv3d.packed_k(ci)) == (8, 27 * cp)
    assert torch.equal(conv3d.unpack_weight(packed, ci), w)
    # column tap * ci_pad + c with tap = (kd * 3 + kh) * 3 + kw; padded channels are zero
    assert torch.equal(packed[:, (1 * 9 + 2 * 3 + 0) * cp + ci - 1], w[:, ci - 1, 1, 2, 0])
    assert not packed.reshape(8, 27, cp)[:, :, ci:].any()
    # the padded weight is the weight of the zero-padded input
    assert torch.equal(conv3d.pack_weight(conv3d.unpack_weight(packed, cp)), packed)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("ci", [5, 24])
def test_channel_padding_matches_jax_reference(ci, relu):
    """What the CUDA wrapper hands its kernel: x's channels zero-padded to
    ci_pad(Ci) against the packed weight, here through the plain version,
    equals JAX's conv3x3x3_reference on the real channels."""
    x, w, b = _inputs(10 + ci, (1, 4, 6, 5), ci, 16)
    padded = conv3d.pad_channels(torch.from_numpy(x))
    assert padded.shape[-1] == conv3d.ci_pad(ci) and not padded[..., ci:].any()
    assert torch.equal(padded[..., :ci], torch.from_numpy(x))
    got = conv3d.conv3x3x3_reference(padded, conv3d.pack_weight(_port_weight(w)), torch.from_numpy(b), relu)
    want = jax_conv3x3x3_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    x64 = torch.zeros(1, 2, 2, 2, 64)
    assert conv3d.pad_channels(x64) is x64


def test_pack_weight_rejects_non_3x3x3():
    with pytest.raises(ValueError):
        conv3d.pack_weight(torch.zeros(8, 8, 1, 1, 1))


def test_unsupported_device_raises():
    x = torch.zeros(1, 4, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d.conv3x3x3(x, torch.zeros(8, conv3d.packed_k(8), device="meta"))
