"""The port's CUDA kernels, its serving and training paths and its command
line, on the card.

Every test here but the last needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch; there, skip the
repo's conftest (it sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import os
import shutil

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
        (1, (16, 16, 16), 5, 64),  # the input conv: Ci = 5 padded to one 8-channel slab
        (1, (5, 5, 5), 3, 136),  # 8-channel slab, ragged Co over 64-wide N tiles
        (2, (9, 7, 13), 8, 24),  # ragged tiles in every dimension, Co below one N tile
        (1, (6, 5, 7), 40, 16),  # Ci padded to one 64-channel chunk
        (1, (3, 3, 3), 24, 136),  # a volume smaller than one tile
        (1, (8, 8, 8), 128, 256),  # K split over the 2 chunks
        (1, (5, 6, 7), 64, 8),
        (4, (8, 8, 8), 1024, 1024),  # the bottleneck's 56.6 MB weight, tile batch 4
        (1, (40, 37, 20), 32, 64),  # ragged y and x tiles
        (2, (32, 32, 32), 64, 128),  # two volumes, 128-wide N tiles, no split
        (1, (16, 16, 16), 256, 512),  # K split over chunk ranges
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize(
    "ci,co,size",
    [
        (64, 64, 128),  # Co = 64 at 128^3: persistent blocks, no split
        (1024, 512, 16),  # persistent, four chains a tile added in FADDs
        (512, 256, 16),  # K split over a cluster of 2 (an H100 SXM), summed on chip
        (1024, 1024, 8),  # the bottleneck: a cluster of 3, chains cut
        (1024, 512, 8),  # dx at the bottleneck: a cluster of 6, slices inside chunks
    ],
)
def test_kernel_launches_bitwise_equal(cuda_device, ci, co, size, dtype):
    """B1 twice on the same inputs: bitwise equal outputs (no atomics; the
    cluster adds its split partials in rank order)."""
    g = torch.Generator(device=cuda_device).manual_seed(ci + co + size)
    x = torch.randn((1, size, size, size, ci), generator=g, device=cuda_device).to(dtype)
    w = torch.randn((co, ci, 3, 3, 3), generator=g, device=cuda_device) * math.sqrt(2.0 / (27 * ci))
    b = torch.randn((co,), generator=g, device=cuda_device) * 0.1
    packed = conv3d.pack_weight(w, dtype)
    for relu in (True, False):
        first = conv3d.conv3x3x3(x, packed, b, relu)
        again = conv3d.conv3x3x3(x, packed, b, relu)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


def test_kernel_without_bias(cuda_device):
    x = torch.randn((1, 6, 6, 6, 16), device=cuda_device).to(torch.bfloat16)
    packed = conv3d.pack_weight(torch.randn((32, 16, 3, 3, 3), device=cuda_device) * 0.1, torch.bfloat16)
    got = conv3d.conv3x3x3(x, packed, None, False)
    assert _within_bf16_bound(got, conv3d.conv3x3x3_reference(x.float(), packed.float(), None, False))


FP32_SHAPES = [
    (1, (16, 16, 16), 5, 64),  # the input conv: Ci = 5 padded to 8, one chunk
    (2, (9, 7, 13), 8, 24),  # ragged tiles in every dimension, Co below one N tile
    (1, (5, 5, 5), 3, 136),  # a ragged last N tile
    (1, (6, 5, 7), 40, 16),  # Ci padded to 64
    (1, (16, 16, 16), 256, 512),  # K split over chunk ranges
    (4, (8, 8, 8), 1024, 1024),  # the bottleneck, split K
    (1, (40, 37, 20), 64, 64),
]


def _fp32_bound(got, ref64, plain):
    """The fp32 kernel no further from float64 than twice the plain fp32
    version (cuDNN, TF32 off), plus 1e-6 of the largest output."""
    err = (got.double() - ref64).abs().max().item()
    return err <= 2 * (plain.double() - ref64).abs().max().item() + 1e-6 * ref64.abs().max().item()


@pytest.mark.parametrize("n,spatial,ci,co", FP32_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_fp32_kernel_matches_float64(cuda_device, n, spatial, ci, co, relu):
    g = torch.Generator(device=cuda_device).manual_seed(ci * co + 1)
    x = torch.randn((n, *spatial, ci), generator=g, device=cuda_device)
    w = torch.randn((co, ci, 3, 3, 3), generator=g, device=cuda_device) * math.sqrt(2.0 / (27 * ci))
    b = torch.randn((co,), generator=g, device=cuda_device)
    packed = conv3d.pack_weight(w, torch.float32)
    before = (conv3d.launches, conv3d.launches_f32)
    got = conv3d.conv3x3x3(x, packed, b, relu)
    torch.cuda.synchronize()
    assert (conv3d.launches, conv3d.launches_f32) == (before[0], before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (n, *spatial, co)
    ref = conv3d.conv3x3x3_reference(x.double(), packed.double(), b, relu)
    assert _fp32_bound(got, ref, conv3d.conv3x3x3_reference(x, packed, b, relu))


@pytest.mark.parametrize("n,spatial,ci,co", FP32_SHAPES)
def test_fp32_dw_kernel_matches_float64(cuda_device, n, spatial, ci, co):
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    g = torch.Generator(device=cuda_device).manual_seed(ci + co + 1)
    x = torch.randn((n, *spatial, ci), generator=g, device=cuda_device)
    dy = torch.randn((n, *spatial, co), generator=g, device=cuda_device)
    before = (conv3d_grad.launches, conv3d_grad.launches_f32)
    got = conv3d_grad.conv3x3_dw(x, dy)
    again = conv3d_grad.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    assert (conv3d_grad.launches, conv3d_grad.launches_f32) == (before[0], before[1] + 2)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, ci, co)
    assert torch.equal(got, again)  # the split partials are summed in a fixed order
    ref = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
    assert _fp32_bound(got, ref, conv3d_grad.conv3x3_dw_reference(x, dy))


def test_fp32_train_step_on_the_card_launches_only_fp32_kernels(cuda_device):
    """compute_dtype='float32' with bf16 params: every conv of the step runs
    the fp32 kernels, none the bf16 ones."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    config = get_config(base_features=8, batch_size=2, accum_steps=1, compute_dtype="float32",
                        param_dtype="bfloat16", target_size=(32, 32, 32))
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    state = create_train_state(model, config)
    batch = {"image": torch.randn((2, 32, 32, 32, 5), device=cuda_device),
             "label": (torch.rand((2, 32, 32, 32, 1), device=cuda_device) > 0.5).to(torch.uint8)}
    conv3d.launches = conv3d.launches_f32 = conv3d_grad.launches = conv3d_grad.launches_f32 = 0
    m = make_train_step(model, config)(state, batch)
    torch.cuda.synchronize()
    assert math.isfinite(float(m["loss"])) and m["grad_norm"].dtype == torch.bfloat16
    assert (conv3d.launches, conv3d.launches_f32, conv3d_grad.launches, conv3d_grad.launches_f32) == (0, 35, 0, 18)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    packed = torch.zeros(8, conv3d.packed_k(8), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # x and weight of two dtypes
        conv3d.conv3x3x3(x.float(), packed)
    with pytest.raises(TypeError):  # a dtype no kernel computes in
        conv3d.conv3x3x3(x.half(), packed.half())
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x, packed[:4])  # Co % 8 != 0
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(torch.zeros(1, 4, 4, 4, 16, device=cuda_device, dtype=torch.bfloat16), packed)
        # (packed K does not match Ci)
    with pytest.raises(ValueError):
        conv3d.conv3x3x3(x.transpose(1, 2), packed)  # not contiguous
    with pytest.raises(ValueError):  # a bias of another length (a bf16 one is cast to fp32, as JAX casts it)
        conv3d.conv3x3x3(x, packed, torch.zeros(4, device=cuda_device, dtype=torch.bfloat16))


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
        (1, (16, 16, 16), 5, 64),  # the input conv: Ci padded to 8, all 27 taps in one block
        (2, (9, 7, 13), 8, 24),  # ragged tiles, Co below one N tile
        (1, (5, 6, 7), 40, 16),  # Ci padded to 64
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


@pytest.mark.parametrize(
    "n,spatial,ci,co",
    [
        (1, (8, 8, 8), 512, 1024),  # 16 channel blocks, 384 blocks, no split
        (1, (32, 32, 32), 64, 64),  # split over voxels (44 splits), fixed-order reduce
    ],
)
@pytest.mark.parametrize("draw", ["channel-blocked", "tile-alternating"])
def test_fp16_dw_kernel_scales_each_chain(cuda_device, n, spatial, ci, co, draw):
    """fp16 B2 sums each chain's dy·2^k_c (k_c from the chain's max|dy|,
    found on the card): on channel-blocked dy (channels 0-63 near 2^13, the
    rest subnormal, 2^-24..2^-21) and on dy whose 2x8x8-voxel tiles alternate
    between 2^-6 and 2^-20 (a pair of tiles cut in two where its second holds
    the larger |dy|), each element within 4.6e-6·Σ|x·dy| of float64 (the
    dw_sum bound), as the plain version is; two launches bitwise equal."""
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    g = torch.Generator(device=cuda_device).manual_seed(ci + co + len(draw))
    shape = (n, *spatial, co)
    x = torch.randn((n, *spatial, ci), generator=g, device=cuda_device).to(torch.float16)
    sign = (torch.rand(shape, generator=g, device=cuda_device) < 0.5).double() * 2 - 1
    if draw == "channel-blocked":
        mag = torch.randint(1, 8, shape, generator=g, device=cuda_device).double() * 2.0**-24
        mag[..., :64] = torch.randn((n, *spatial, 64), generator=g, device=cuda_device).abs().double() * 2.0**11
    else:
        d, h, w = spatial
        tile = (torch.arange(d, device=cuda_device).view(d, 1, 1) // 2 * (h // 8)
                + torch.arange(h, device=cuda_device).view(1, h, 1) // 8) * (w // 8) \
            + torch.arange(w, device=cuda_device).view(1, 1, w) // 8
        exponent = torch.where(tile % 3 == 1, -6.0, -20.0).double().unsqueeze(-1)  # pairs (0, 1) cut, (2, 3) not
        mag = torch.randn(shape, generator=g, device=cuda_device).abs().double() * torch.exp2(exponent)
    dy = (mag * sign).to(torch.float16)
    before = conv3d_grad.launches_f16
    got = conv3d_grad.conv3x3_dw(x, dy)
    again = conv3d_grad.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    assert conv3d_grad.launches_f16 == before + 2
    assert torch.equal(got, again)
    exact = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
    scale = conv3d_grad.conv3x3_dw_reference(x.double().abs(), dy.double().abs()).clamp_min(1e-300)
    plain = conv3d_grad.conv3x3_dw_reference(x, dy).double()
    assert bool(torch.isfinite(got).all())
    assert ((got.double() - exact).abs() / scale).max().item() <= 4.6e-6
    assert ((plain - exact).abs() / scale).max().item() <= 4.6e-6


def test_dw_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # x and dy of two dtypes
        conv3d_grad.conv3x3_dw(x.float(), x)
    with pytest.raises(TypeError):  # a dtype no kernel computes in
        conv3d_grad.conv3x3_dw(x.double(), x.double())
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
    from pcmseg_tpu_torch.core.config import get_config
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


# ---- the device data cache ------------------------------------------------------------


def test_cached_training_on_the_card(cuda_device, tmp_path):
    """The stacks live on the card, and a cached epoch cropped and augmented
    there (every transform on) runs every kernel with a finite loss."""
    from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES, get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad
    from pcmseg_tpu_torch.train.trainer import Trainer

    _write_tree(str(tmp_path / "data"), DEFAULT_MODALITIES)
    config = get_config(data_dir=str(tmp_path / "data"), save_dir=str(tmp_path / "ckpt"),
                        cache_dir=str(tmp_path / "cache"), base_features=8, target_size=(32, 32, 32), batch_size=2,
                        num_epochs=1, train_crop=(16, 16, 16), oversample_fg=0.33, data_augmentation=True,
                        aug_scale=0.15, aug_rotate_deg=15.0, aug_gamma=0.3, aug_noise=0.1, aug_blur_prob=0.5)
    trainer = Trainer(config)
    cache = trainer._dcache
    assert cache["images"].device.type == "cuda" and cache["labels"].device.type == "cuda"
    assert cache["images"].dtype == torch.bfloat16 and cache["labels"].dtype == torch.uint8
    b1, b2 = conv3d.launches, conv3d_grad.launches
    assert math.isfinite(trainer.train_epoch())
    steps = math.ceil(len(trainer.train_indices) / 2)
    # per step (remat on): 18 forward, 18 recomputed, 17 dx; 18 dW
    assert (conv3d.launches - b1, conv3d_grad.launches - b2) == (steps * 53, steps * 18)


def test_folds_on_cuda_and_cuda0_share_one_upload(cuda_device, tmp_path):
    from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES, get_config
    from pcmseg_tpu_torch.data import device_cache
    from pcmseg_tpu_torch.train.trainer import Trainer

    _write_tree(str(tmp_path / "data"), DEFAULT_MODALITIES)
    config = get_config(data_dir=str(tmp_path / "data"), save_dir=str(tmp_path / "ckpt"),
                        cache_dir=str(tmp_path / "cache"), base_features=8, target_size=(32, 32, 32))
    before = device_cache.uploads
    first = Trainer(config, device="cuda", train_indices=[0, 1], val_indices=[2, 3])
    second = Trainer(config, device="cuda:0", train_indices=[2, 3], val_indices=[0, 1], dataset=first.dataset)
    assert device_cache.uploads - before == 1 and second._dcache is first._dcache
    assert list(first.dataset._device_cache_memo) == [f"cuda:{torch.cuda.current_device()}"]


def test_transforms_on_the_card_match_the_cpu(cuda_device):
    """The warp, the blur and the gamma branch at given parameters, on the
    card and on the CPU, from the same tensors; no NaN from the gamma's pow
    at the minimum voxel."""
    from pcmseg_tpu_torch.data import device_cache

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.normal(size=(24, 20, 28, 5)).astype(np.float32))
    lab = torch.from_numpy((rng.random((24, 20, 28, 1)) > 0.7).astype(np.uint8))
    for angle, zoom in ((0.3, 0.9), (-0.2, 1.15)):
        cpu = device_cache._affine_warp(img, lab, angle, zoom)
        gpu = device_cache._affine_warp(img.to(cuda_device), lab.to(cuda_device), angle, zoom)
        assert (gpu[0].cpu() - cpu[0]).abs().max().item() <= 1e-5
        assert torch.equal(gpu[1].cpu(), cpu[1])
    blurred = device_cache._separable_blur(img.to(cuda_device), 0.8).cpu()
    assert (blurred - device_cache._separable_blur(img, 0.8)).abs().max().item() <= 1e-6
    x = img.to(torch.bfloat16)
    for g in (0.75, 1.3):
        out = device_cache._gamma(x.to(cuda_device), g).cpu()
        assert torch.isfinite(out.float()).all()
        assert (out.float() - device_cache._gamma(x, g).float()).abs().max().item() <= 0.05  # one bf16 ulp at |x| < 8


# ---- every verb of the command line on the card -------------------------------------


def _write_tree(root, modalities, n_cases=4, shape=(34, 32, 33)):
    """A training tree of random volumes ({root}/BPH-PCA/BPH/{modality}/{case}.nii.gz,
    labels under ROI(BPH+PCA)/BPH)."""
    from pcmseg_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(0)
    label_dir = f"{root}/BPH-PCA/ROI(BPH+PCA)/BPH"
    for i in range(n_cases):
        for m in modalities:
            os.makedirs(f"{root}/BPH-PCA/BPH/{m}", exist_ok=True)
            write_nifti(rng.normal(100, 30, size=shape).astype(np.int16), f"{root}/BPH-PCA/BPH/{m}/c{i}.nii.gz")
        os.makedirs(label_dir, exist_ok=True)
        write_nifti((rng.random(shape) > 0.8).astype(np.uint8), f"{label_dir}/c{i}.nii.gz")


def test_every_verb_on_the_card(cuda_device, tmp_path, capsys):
    """check, train --cross_validation, validate (ensemble + TTA, and
    --native), predict, serve, export and warm-cache run on the card."""
    from pcmseg_tpu_torch.cli.main import main
    from pcmseg_tpu_torch.core.config import DEFAULT_MODALITIES
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    data, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    _write_tree(data, DEFAULT_MODALITIES)
    common = ["--data_dir", data, "--save_dir", ckpt, "--cache_dir", str(tmp_path / "cache")]
    assert main(["warm-cache", *common, "--target_size", "32", "32", "32"]) == 0
    b1, b2 = conv3d.launches, conv3d_grad.launches
    assert main(["train", "--cross_validation", "--n_splits", "2", "--epochs", "1", "--target_size", "32", "32",
                 "32", "--base_features", "8", "--batch_size", "2", *common]) == 0
    assert conv3d.launches > b1 and conv3d_grad.launches > b2
    folds = os.path.join(ckpt, "best_fold_*.pth")
    b1 = conv3d.launches
    assert main(["validate", "--model_path", folds, "--tta", "--batch_size", "4", *common]) == 0
    assert conv3d.launches - b1 == 18 * 2 * 8 * 1  # one batch of 4: 2 members x 8 flips
    assert main(["validate", "--model_path", folds, "--native", "--surface_metrics", *common]) == 0
    case = str(tmp_path / "case")
    for m in DEFAULT_MODALITIES:
        os.makedirs(os.path.join(case, m))
        shutil.copy(f"{data}/BPH-PCA/BPH/{m}/c0.nii.gz", os.path.join(case, m, "t.nii.gz"))
    assert main(["predict", "--model_path", folds, "--input_dir", case, "--output_dir", str(tmp_path / "out"),
                 "--postprocess", "largest_cc"]) == 0
    os.makedirs(tmp_path / "inbox")
    os.rename(case, tmp_path / "inbox" / "c0")
    assert main(["serve", "--model_path", folds, "--input_root", str(tmp_path / "inbox"), "--output_dir",
                 str(tmp_path / "served"), "--once", "--tta"]) == 0
    assert main(["export", "--model_path", os.path.join(ckpt, "latest_fold_1.pt"), "--output",
                 str(tmp_path / "m.pth")]) == 0
    assert main(["check", *common[:4], "--output", str(tmp_path / "report.json")]) == 0
    assert "devices: " in capsys.readouterr().out


def test_validate_without_a_card_needs_cpu(tmp_path, monkeypatch, capsys):
    """On a machine without a card (or told there is none) ``validate``
    fails unless given ``--device cpu``."""
    from pcmseg_tpu_torch.cli.main import main
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.train.checkpoints import save_pth

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = get_config(base_features=4)
    pth = save_pth(str(tmp_path / "m.pth"), UNet3D.from_config(config).state_dict(), config.to_dict())
    assert main(["validate", "--model_path", pth, "--data_dir", str(tmp_path)]) != 0
    assert "--device cpu" in capsys.readouterr().err


def test_span_holds_a_b1_launch_and_its_kernel(cuda_device):
    """A span around a B1 launch and a ``synchronize()``, live because a
    CUDA-only profiler runs: its interval holds the launch call (the host
    event of the kernel's correlation id, on the span's thread) and the
    kernel's device interval, all on one clock."""
    from torch.profiler import ProfilerActivity, profile

    from pcmseg_tpu_torch.utils.profiling import drain_spans, span

    x = torch.randn((1, 16, 16, 16, 64), device=cuda_device).to(torch.bfloat16)
    packed = conv3d.pack_weight(torch.randn((64, 64, 3, 3, 3), device=cuda_device) * 0.05, torch.bfloat16)
    b = torch.zeros(64, device=cuda_device)
    conv3d.conv3x3x3(x, packed, b, True)  # built and loaded before the profile
    torch.cuda.synchronize()
    drain_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("b1"):
            conv3d.conv3x3x3(x, packed, b, True)
            torch.cuda.synchronize()
    (s,) = [r for r in drain_spans().records if r.name == "b1"]
    events = list(prof.profiler.kineto_results.events())
    (kernel,) = [e for e in events if e.device_type().name == "CUDA" and "conv3x3x3_kernel" in e.name()]
    launch = min((e for e in events if e.device_type().name == "CPU" and e.correlation_id() == kernel.correlation_id()),
                 key=lambda e: e.start_ns())
    assert "Launch" in launch.name()
    for e in (launch, kernel):
        assert s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
    assert launch.device_resource_id() & 0xFFFFFFFF == s.thread & 0xFFFFFFFF
