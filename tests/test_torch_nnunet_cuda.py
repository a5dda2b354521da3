"""nnU-Net's PlainConvUNet on the card, at the published features (32, 64,
128, 256, 320, 320), N = 2: the launches of one train step at 64³, counted
exactly, and the first step's gradients against the plain fp32 reference
(``tests/plain_nnunet.py``) at 64³ and, in bf16, at the cell's 128³.

Every test needs an NVIDIA GPU and skips without one. The file imports no
JAX; on a machine that has only PyTorch, skip the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nnunet_cuda.py
"""

import numpy as np
import pytest
import torch

import plain_nnunet as ref
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.models import build_model, nnunet
from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

pytestmark = pytest.mark.cuda

FEATURES = (32, 64, 128, 256, 320, 320)
SIZE = (64, 64, 64)
SETTINGS = dict(n_modalities=5, n_classes=3, nnunet_features=FEATURES, learning_rate=1e-2, momentum=0.99,
                weight_decay=3e-5, grad_clip_norm=12.0, dice_smooth=1e-5, deep_supervision=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def config(dtype, size=SIZE):
    return get_config(model="nnunet", n_classes=3, nnunet_features=FEATURES, compute_dtype=dtype, target_size=size,
                      deep_supervision=True, optimizer="sgd", learning_rate=1e-2, weight_decay=3e-5, grad_clip_norm=12.0, loss="bce_dice", bce_weight=1.0, dice_weight=1.0,
                      dice_smooth=1e-5, ema_decay=0.0, batch_size=2, accum_steps=1, remat=False)


def batch(device, seed=0, size=SIZE):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((2, *size, 5), generator=g, device=device),
            torch.randint(0, 3, (2, *size, 1), generator=g, device=device).to(torch.uint8))


def step_once(cfg, device, sd, x, y):
    """(the momentum buffers after one step, per leaf; the loss)."""
    model = build_model(cfg, deep_supervision=True, device="meta")
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    state = create_train_state(model, cfg)
    out = make_train_step(model, cfg)(state, {"image": x, "label": y})
    torch.cuda.synchronize(device)
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: s["momentum_buffer"] for p, s in state.optimizer.state.items()}, float(out["loss"])


def test_a_train_step_launches_exactly(cuda_device):
    """One bf16 step: B1 17 forward + 16 dx (the input conv needs none), B2
    17, the strided convs 5 and the norms 22 forwards (one after each of the
    22 convs), no fp32 or fp16 conv."""
    cfg = config("bfloat16")
    sd = ref.init_state(SETTINGS, 7, cuda_device)
    x, y = batch(cuda_device)
    step_once(cfg, cuda_device, sd, x, y)  # build the kernels, warm up
    conv3d.launches = conv3d.launches_f32 = conv3d.launches_f16 = 0
    conv3d_grad.launches = conv3d_grad.launches_f32 = conv3d_grad.launches_f16 = 0
    nnunet.strided_launches = nnunet.instance_norm_calls = 0
    step_once(cfg, cuda_device, sd, x, y)
    assert (conv3d.launches, conv3d_grad.launches) == (33, 17)
    assert (nnunet.strided_launches, nnunet.instance_norm_calls) == (5, 22)
    assert conv3d.launches_f32 == conv3d.launches_f16 == conv3d_grad.launches_f32 == conv3d_grad.launches_f16 == 0


def _gaps(got, want):
    """Per leaf ‖got − want‖ / max(‖want‖, the median leaf's ‖want‖)."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k].double() - w.double()).norm()) / max(norms[k], med) for k, w in want.items()}


def _whole(got, want):
    """‖got − want‖ / ‖want‖ over every leaf at once."""
    return float(np.sqrt(sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
                         / sum(float(w.double().square().sum()) for w in want.values())))


def _first_step(device, size, dtypes):
    """For each compute dtype: (the port's first-step loss, the reference's,
    per-leaf gaps, the whole gradient's gap) on one seeded batch of 2."""
    sd = ref.init_state(SETTINGS, 11, device)
    x, y = batch(device, 1, size)
    want_state = {k: v.clone() for k, v in sd.items()}
    with ref.no_tf32():
        want_loss, want = ref.train_steps(want_state, [(x, y)], SETTINGS)
    out = {}
    for dtype in dtypes:
        got, loss = step_once(config(dtype, size), device, sd, x, y)
        assert set(got) == set(want)
        gaps, whole = _gaps(got, want), _whole(got, want)
        worst = max(gaps, key=gaps.get)
        print(dtype, size, "loss", loss, want_loss[0], "worst", worst, gaps[worst], "median",
              np.median(list(gaps.values())), "whole", whole)
        out[dtype] = loss, want_loss[0], gaps, whole
    # a leaf zeroed or doubled: its gap reads 1 wherever its norm is at least the median's
    big = max(want, key=lambda k: float(want[k].norm()))
    zeroed = _gaps(dict(want, **{big: torch.zeros_like(want[big])}), want)[big]
    return out, zeroed


def test_first_step_gradients_match_the_fp32_reference(cuda_device):
    """The first step's gradient as SGD took it (momentum buffer) against
    the reference in fp32 (TF32 off) at 64³. The port in fp32 (3×TF32 B1 and B2,
    cuDNN's strided convs with TF32 off): each leaf within 1e-2 of max(its
    norm, the median leaf's), the whole gradient within 1e-2: the norms'
    scale and shift sum dy·x̂ over 2·64³ voxels with cancellation, and fp32
    itself is 6.4e-3 off float64 there (the reference; the port 3.6e-3,
    measured on the CPU; on the card 5.5e-3 apart, 3.4e-3 whole). The port in bf16,
    its compute dtype: the whole gradient within 0.4 and each leaf within
    0.7 (dy rounded to 8 bits before each InstanceNorm's backward, whose
    cancellation amplifies it, the more the fewer voxels a norm has: at
    64³ the last stage is 2³; measured 0.32–0.34 whole and 0.49 at the
    worst leaf, the first norm's scale), below the 1.0 that a leaf zeroed
    or doubled reads."""
    out, zeroed = _first_step(cuda_device, (64, 64, 64), ("float32", "bfloat16"))
    for dtype, leaf_bound, whole_bound in (("float32", 1e-2, 1e-2), ("bfloat16", 0.7, 0.4)):
        loss, want_loss, gaps, whole = out[dtype]
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= leaf_bound and whole <= whole_bound, (dtype, worst, gaps[worst], whole)
        assert abs(loss - want_loss) <= (1e-5 if dtype == "float32" else 1e-2) * abs(want_loss)
    assert zeroed > 0.7


def test_bf16_first_step_gradient_at_the_cells_size(cuda_device):
    """The bf16 step the benchmark's cell times, at its 128³, against the
    fp32 reference: each leaf within 0.7 and the whole gradient within 0.3
    (measured 0.42–0.48 at the worst leaf and 0.22–0.24 whole on this batch
    of uniform noise and random labels), below the 1.0 that a leaf zeroed
    or doubled reads; the loss within 1e-2."""
    out, zeroed = _first_step(cuda_device, (128, 128, 128), ("bfloat16",))
    loss, want_loss, gaps, whole = out["bfloat16"]
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 0.7 and whole <= 0.3, (worst, gaps[worst], whole)
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    assert zeroed > 0.7
