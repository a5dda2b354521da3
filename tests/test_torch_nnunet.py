"""nnU-Net's PlainConvUNet in the port (``models/nnunet.py``) against the
plain reference (``tests/plain_nnunet.py``) on seeded weights, on the CPU at
a small plan: 4 stages of (4, 8, 16, 16) features, 5 modalities, K = 3,
N = 2. Every head's logits, the deep-supervised loss, each leaf's gradient
and one Nesterov SGD step in fp32; the bf16 forward; per-sample statistics;
the published plan's parameter count; a mesh refused; a ``.pth`` served by
the Predictor with TTA; the Trainer through the device cache; and the
benchmark's copy of the reference."""

import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_nnunet as ref
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu_torch.cli.parser import _config_from_args, build_parser
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.models import build_model
from pcmseg_tpu_torch.models.nnunet import PlainConvUNet
from pcmseg_tpu_torch.models.unet3d import param_count
from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth
from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (4, 8, 16, 16)
# the reference's config keys, nnU-Net's trainer settings
SETTINGS = dict(n_modalities=5, n_classes=3, nnunet_features=FEATURES, learning_rate=1e-2, momentum=0.99,
                weight_decay=3e-5, grad_clip_norm=12.0, dice_smooth=1e-5, deep_supervision=True)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_config(**kw):
    base = dict(model="nnunet", n_classes=3, nnunet_features=FEATURES, compute_dtype="float32",
                target_size=(32, 32, 32), deep_supervision=True, optimizer="sgd", learning_rate=1e-2,
                weight_decay=3e-5, grad_clip_norm=12.0, loss="bce_dice",
                bce_weight=1.0, dice_weight=1.0, dice_smooth=1e-5, ema_decay=0.0, batch_size=2, accum_steps=1,
                remat=False)
    return get_config(**dict(base, **kw))


def seeded(config, seed=3, **kw):
    """(the port's model holding the reference's seeded weights, those weights)."""
    sd = ref.init_state(SETTINGS, seed, "cpu")
    model = build_model(config, device="meta", **kw)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    return model, sd


def batch(seed=0, size=(32, 32, 32)):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((2, *size, 5), generator=g),
            torch.randint(0, 3, (2, *size, 1), generator=g).to(torch.uint8))


def channels_last(t):
    return t.permute(0, 2, 3, 4, 1)


def test_every_head_matches_the_reference_in_fp32():
    """Full-resolution logits and the 1/2 head of the training forward, on a
    volume whose three dims differ. fp32 on both sides, the convs and norms
    summed in other orders (the norm's fast variance against
    ``F.instance_norm``'s): measured within 2e-6 of the logits' scale."""
    config = port_config()
    model, sd = seeded(config, deep_supervision=True)
    x, _ = batch(size=(16, 24, 32))
    logits, aux = model.train()(x)
    want, want_aux = ref.forward(sd, x.permute(0, 4, 1, 2, 3), deep_supervision=True)
    assert len(aux) == len(want_aux) == 1 and aux[0].shape == (2, 8, 12, 16, 3)
    for got, exp in zip((logits, *aux), (want, *want_aux)):
        exp = channels_last(exp)
        assert got.dtype == torch.float32 and got.shape == exp.shape
        assert float((got.detach() - exp).abs().max()) <= 1e-5 * float(exp.abs().max())


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_loss_gradients_and_one_nesterov_step_match_the_reference(remat):
    """One train step of the port (``make_train_step`` with SGD; each stage
    recomputed in the backward with ``remat``) against the
    reference's: the loss (relative 1e-5: sums over 2·32³ voxels), each
    leaf's gradient as SGD took it (its momentum buffer, g + wd·p) within
    1e-3 of max(its norm, the median leaf's) (fp32 sums in other orders; a
    norm's shift sums dy with cancellation: measured 2.5e-4), and every
    parameter after the step within 1e-6 (the step moves them by up to
    3e-3). The lowest head is frozen: no gradient, unchanged."""
    config = port_config(remat=remat)
    model, sd = seeded(config, deep_supervision=True)
    state = create_train_state(model, config)
    assert isinstance(state.optimizer, torch.optim.SGD)
    assert state.optimizer.param_groups[0]["nesterov"] and state.optimizer.param_groups[0]["momentum"] == 0.99
    x, y = batch()
    out = make_train_step(model, config)(state, {"image": x, "label": y})
    want_state = {k: v.clone() for k, v in sd.items()}
    losses, first = ref.train_steps(want_state, [(x, y)], SETTINGS)
    assert abs(float(out["loss"]) - losses[0]) <= 1e-5 * abs(losses[0])

    names = {id(p): k for k, p in model.named_parameters()}
    bufs = {names[id(p)]: s["momentum_buffer"] for p, s in state.optimizer.state.items()}
    assert set(bufs) == set(first) and "decoder.seg_layers.0.weight" not in bufs
    norms = {k: float(v.norm()) for k, v in first.items()}
    med = float(np.median(list(norms.values())))
    for k, b in bufs.items():
        assert float((b - first[k]).norm()) <= 1e-3 * max(norms[k], med), k

    got = model.state_dict()
    for k, v in want_state.items():
        assert float((got[k] - v).abs().max()) <= 1e-6, k
    assert torch.equal(got["decoder.seg_layers.0.weight"], sd["decoder.seg_layers.0.weight"])
    assert model.decoder.seg_layers[0].weight.grad is None
    assert max(float((got[k] - sd[k]).abs().max()) for k in sd) > 1e-3  # the step moved them


def test_bf16_forward_is_within_bf16_rounding_of_the_reference():
    """The eval forward in bf16 against the fp32 reference: relative L2
    error under 0.05 of the logits (every activation rounded to bf16's 8
    bits, 2^-9 relative, over 14 convs, norms and heads: measured 0.020),
    while the fp32 forward is within 1e-5."""
    x, _ = batch()
    want = channels_last(ref.forward(ref.init_state(SETTINGS, 3, "cpu"), x.permute(0, 4, 1, 2, 3)))
    errs = {}
    for dtype in ("bfloat16", "float32"):
        model, _ = seeded(port_config(compute_dtype=dtype))
        with torch.no_grad():
            errs[dtype] = float((model.eval()(x) - want).norm() / want.norm())
    assert errs["bfloat16"] < 0.05 and errs["float32"] < 1e-5, errs


def test_eval_statistics_are_per_sample():
    """InstanceNorm's statistics are each sample's own in eval as in
    training: sample 0's logits are the same whatever sample 1 holds."""
    model, _ = seeded(port_config())
    x, _ = batch()
    other = x.clone()
    other[1] = other[1] * 3.0 + 1.0
    with torch.no_grad():
        a, b = model.eval()(x), model(other)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])


def test_published_plan_has_31199855_parameters():
    """nnU-Net's 3d_fullres plan at 5 modalities and 3 classes, counted on
    the meta device: every head a parameter, in PlainConvUNet's key order."""
    config = get_config(model="nnunet", n_classes=3)
    model = build_model(config, device="meta", deep_supervision=True)
    assert isinstance(model, PlainConvUNet) and config.nnunet_features == (32, 64, 128, 256, 320, 320)
    assert param_count(model) == 31_199_855
    shapes = ref.state_shapes(5, 3, config.nnunet_features)
    assert list(model.state_dict()) == list(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in model.state_dict().items())
    trained = {k for k, p in model.named_parameters() if p.requires_grad}
    assert trained == {k for k in shapes if ref.trained(k, 6)}
    assert sum(math.prod(shapes[k]) for k in set(shapes) - trained) == 320 * 3 + 3  # the 1/16 head


@pytest.mark.parametrize("mesh", [dict(spatial_parallel=2), dict(tensor_parallel=2)], ids=["spatial", "tensor"])
def test_a_mesh_is_refused(mesh):
    with pytest.raises(NotImplementedError, match="nnU-Net"):
        build_model(get_config(model="nnunet", **mesh), device="meta")


def test_the_cli_builds_an_nnunet_sgd_config():
    args = build_parser().parse_args(["train", "--model", "nnunet", "--optimizer", "sgd", "--n_classes", "3",
                                      "--device", "cpu"])
    config = _config_from_args(args)
    assert (config.model, config.optimizer) == ("nnunet", "sgd")
    with pytest.raises(ValueError, match="model"):
        get_config(model="vnet")


def test_pth_round_trip_through_the_predictor(tmp_path):
    """A ``.pth`` of the port's state dict with its config snapshot, served
    by the Predictor unfolded with 8-flip TTA: its probabilities are the
    reference's softmax averaged over the flips (fp32; 2e-6)."""
    from pcmseg_tpu_torch.infer.predict import Predictor

    config = port_config()
    model, sd = seeded(config)
    path = save_pth(str(tmp_path / "nnunet.pth"), model.state_dict(), config.to_dict())
    assert set(load_pth(path)[0]) == set(sd)
    predictor = Predictor(get_config("standard", tta=True, compute_dtype="float32"), path, device="cpu")
    assert predictor.config.model == "nnunet" and predictor.config.nnunet_features == FEATURES
    assert isinstance(predictor.models[0], PlainConvUNet)
    x, _ = batch(size=(16, 16, 16))
    got = predictor.predict_probs_batch(x.numpy())
    total = 0
    for axes in ref_flips():
        xi = torch.flip(x, axes) if axes else x
        p = channels_last(torch.softmax(ref.forward(sd, xi.permute(0, 4, 1, 2, 3)), 1))
        total = total + (torch.flip(p, axes) if axes else p)
    np.testing.assert_allclose(got, (total / 8).numpy(), atol=2e-6)
    labels = predictor.predict_mask(x[0].numpy())
    assert labels.dtype == np.uint8 and labels.shape == (16, 16, 16) and labels.max() <= 2


def ref_flips():
    """The 8 flips of (D, H, W) as axes of an NDHWC tensor."""
    return [tuple(a for a, on in zip((1, 2, 3), (d, h, w)) if on)
            for d in (False, True) for h in (False, True) for w in (False, True)]


def test_trainer_trains_nnunet_from_the_device_cache(tmp_path):
    """``Trainer`` with ``model='nnunet'`` and SGD: one epoch from the
    device cache, finite losses, and a ``best.pth`` in PlainConvUNet's
    layout with every head, which the Predictor takes."""
    from pcmseg_tpu_torch.train.trainer import Trainer

    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_cases=4, shape=(20, 18, 22), seed=21, n_classes=3)
    config = port_config(data_dir=data, save_dir=str(tmp_path / "run"), cache_dir=str(tmp_path / "cache"),
                         target_size=(16, 16, 16), batch_size=2, num_epochs=1, early_stopping=False,
                         val_fraction=0.25, scheduler="poly", seed=0)
    trainer = Trainer(config, device="cpu")
    assert isinstance(trainer.state.model, PlainConvUNet) and trainer._dcache is not None
    history = trainer.train()
    assert len(history["train_loss"]) == 1 and all(np.isfinite(v) for v in history["train_loss"] + history["val_loss"])
    sd, snapshot = load_pth(os.path.join(config.save_dir, "best.pth"))
    assert snapshot["model"] == "nnunet" and set(sd) == set(ref.state_shapes(5, 3, FEATURES))


def test_the_benchmark_copy_of_the_reference_is_identical():
    copy = (ROOT / "benchmark" / "reference" / "nnunet.py").read_text()
    assert copy == (ROOT / "tests" / "plain_nnunet.py").read_text()
