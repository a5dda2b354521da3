"""The port's CUDA kernel and GPU serving path, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch; there, skip the
repo's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from pcmseg_tpu_torch.infer.sliding_window import make_sliding_window
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.ops.kernels import conv3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_bf16_bound(got, want):
    """One bf16 rounding of the output plus fp32 reassociation."""
    err = (got.float() - want).abs()
    return bool((err <= 8e-3 * want.abs() + 1e-3 * want.abs().max()).all())


@pytest.mark.parametrize(
    "n,spatial,ci,co",
    [
        (1, (16, 16, 16), 5, 64),  # the input conv: Ci = 5, gather kernel, K padded
        (1, (5, 5, 5), 3, 136),  # gather kernel with the 128-wide N tile, ragged Co
        (2, (9, 7, 13), 8, 24),  # halo kernel, one partial channel chunk, ragged tiles
        (1, (6, 5, 7), 40, 16),  # a full chunk and a partial one, Co below one N tile
        (1, (3, 3, 3), 24, 136),  # partial chunk, Co not a multiple of the N tile
        (1, (8, 8, 8), 128, 256),  # K split over 4 chunk ranges
        (1, (5, 6, 7), 64, 8),
        (4, (8, 8, 8), 1024, 1024),  # the bottleneck's 56.6 MB weight, tile batch 4
        (1, (40, 37, 20), 32, 64),  # ragged y and x tiles, no split
        (2, (32, 32, 32), 64, 128),  # two volumes, no split
        (1, (16, 16, 16), 256, 512),  # K split over 3 chunk ranges
    ],
)
@pytest.mark.parametrize("relu", [True, False])
def test_kernel_matches_plain(cuda_device, n, spatial, ci, co, relu):
    g = torch.Generator(device=cuda_device).manual_seed(ci * co)
    x = torch.randn((n, *spatial, ci), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((co, ci, 3, 3, 3), generator=g, device=cuda_device) * math.sqrt(2.0 / (27 * ci))
    b = torch.randn((co,), generator=g, device=cuda_device)
    packed = conv3d.pack_weight(w, torch.bfloat16)
    before = conv3d.launches
    got = conv3d.conv3x3x3(x, packed, b, relu)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 1
    want = conv3d.conv3x3x3_reference(x.float(), packed.float(), b, relu)
    assert got.dtype == torch.bfloat16 and got.shape == (n, *spatial, co)
    assert _within_bf16_bound(got, want)


def test_kernel_without_bias(cuda_device):
    x = torch.randn((1, 6, 6, 6, 16), device=cuda_device).to(torch.bfloat16)
    packed = conv3d.pack_weight(torch.randn((32, 16, 3, 3, 3), device=cuda_device) * 0.1, torch.bfloat16)
    got = conv3d.conv3x3x3(x, packed, None, False)
    assert _within_bf16_bound(got, conv3d.conv3x3x3_reference(x.float(), packed.float(), None, False))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    packed = torch.zeros(8, conv3d.packed_k(8), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv3d.conv3x3x3(x.float(), packed.float())
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x, packed[:4])  # Co % 8 != 0
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x[..., :4].contiguous(), packed)  # packed K does not match Ci
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x.transpose(1, 2), packed)  # not contiguous
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x, packed, torch.zeros(8, device=cuda_device, dtype=torch.bfloat16))


def test_folded_model_on_the_card_matches_fp32_cpu(cuda_device):
    """UNet3D(norm='none') forward in bf16 through the kernel against the
    same weights in fp32 on the CPU: 18 launches, probabilities close."""
    cpu = UNet3D(base_features=8, norm_layer="none", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(0)).eval()
    gpu = UNet3D(base_features=8, norm_layer="none").eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 32, 5)).astype(np.float32))
    before = conv3d.launches
    with torch.inference_mode():
        got = gpu.predict(x.to(cuda_device)).cpu()
        want = cpu.predict(x)
    assert conv3d.launches == before + 18
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 2e-2  # bf16 activations through 18 convs


def test_tiled_predict_on_the_card_matches_whole_volume(cuda_device):
    model = UNet3D(base_features=8, norm_layer="none",
                   generator=torch.Generator().manual_seed(1)).eval().to(cuda_device)
    x = torch.randn((32, 32, 32, 5), device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        run = make_sliding_window(model.predict, (32, 32, 32), 5, 1, window_size=(32, 32, 32),
                                  overlap=0.5, tile_batch=4, device=cuda_device)
        tiled = run(x)
        whole = model.predict(x[None])[0]
    # one window covers the volume: the blend divides by its own weight
    assert torch.allclose(tiled, whole, atol=1e-6)


# ---- the training path: weight-gradient kernel, conv Function, train step ----


@pytest.mark.parametrize(
    "n,spatial,ci,co",
    [
        (1, (16, 16, 16), 5, 64),  # the input conv: scalar gather, M = 135 padded
        (2, (9, 7, 13), 8, 24),  # 8-row groups spanning taps, ragged K and Co
        (1, (5, 6, 7), 40, 16),
        (1, (8, 8, 8), 1024, 1024),  # the bottleneck: many blocks, no split
        (1, (32, 32, 32), 64, 64),  # split over voxels, fixed-order reduce
        (2, (16, 16, 16), 256, 512),
    ],
)
def test_dw_kernel_matches_plain(cuda_device, n, spatial, ci, co):
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    g = torch.Generator(device=cuda_device).manual_seed(ci + co)
    x = torch.randn((n, *spatial, ci), generator=g, device=cuda_device).to(torch.bfloat16)
    dy = torch.randn((n, *spatial, co), generator=g, device=cuda_device).to(torch.bfloat16)
    before = conv3d_grad.launches
    got = conv3d_grad.conv3x3_dw(x, dy)
    again = conv3d_grad.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    assert conv3d_grad.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, ci, co)
    assert torch.equal(got, again)  # the split-K partials are summed in a fixed order
    want = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
    # fp32 sums of the same bf16 products in another order
    assert (got - want).abs().max().item() <= 2e-3 * want.abs().max().item()


def test_dw_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv3d_grad.conv3x3_dw(x.float(), x.float())
    with pytest.raises(ValueError):
        conv3d_grad.conv3x3_dw(x, x[..., :4].contiguous())  # Co % 8 != 0
    with pytest.raises(ValueError):
        conv3d_grad.conv3x3_dw(x, x[:, :2].contiguous())  # spatial mismatch
    with pytest.raises(ValueError):
        conv3d_grad.conv3x3_dw(x.transpose(1, 2), x)  # not contiguous


def test_conv_function_on_the_card_matches_fp32(cuda_device):
    from pcmseg_tpu_torch.ops import hybrid_conv
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 12, 10, 16, 32), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((64, 32, 3, 3, 3), generator=g, device=cuda_device) * 0.05
    b = torch.randn((64,), generator=g, device=cuda_device)
    dy = torch.randn((2, 12, 10, 16, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    results = []
    for dtype, fn in ((torch.bfloat16, hybrid_conv.conv3x3), (torch.float32, hybrid_conv.conv3x3_plain)):
        xi = x.to(dtype).detach().requires_grad_()
        wi, bi = w.clone().requires_grad_(), b.clone().requires_grad_()
        b1, b2 = conv3d.launches, conv3d_grad.launches
        y = fn(xi, wi, bi, conv3d.pack_weight(w, dtype))
        y.backward(dy.to(dtype))
        if dtype == torch.bfloat16:
            assert (conv3d.launches - b1, conv3d_grad.launches - b2) == (2, 1)  # forward + dx, dW
        results.append([t.float() for t in (y, xi.grad, wi.grad, bi.grad)])
    for name, got, want in zip(("y", "dx", "dw", "db"), *results):
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (name, err)  # bf16 operands and outputs


def test_train_step_on_the_card_launches_every_kernel(cuda_device):
    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    config = get_config(base_features=8, batch_size=2, accum_steps=2, remat=True)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    state = create_train_state(model, config)
    batch = {"image": torch.randn((2, 32, 32, 32, 5), device=cuda_device).to(torch.bfloat16),
             "label": (torch.rand((2, 32, 32, 32, 1), device=cuda_device) > 0.7).to(torch.uint8)}
    b1, b2 = conv3d.launches, conv3d_grad.launches
    metrics = make_train_step(model, config)(state, batch)
    torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))
    # per microbatch: 18 forward, 18 recomputed (remat), 17 dx; 18 dW
    assert conv3d.launches - b1 == 2 * (18 + 18 + 17)
    assert conv3d_grad.launches - b2 == 2 * 18
