"""Port's losses, metrics and label alignment (ops/losses.py, ops/metrics.py,
train/steps.py::align_labels) against the JAX package, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.ops import losses as jax_losses
from pcmseg_tpu.ops import metrics as jax_metrics
from pcmseg_tpu.train.steps import align_labels as jax_align_labels
from pcmseg_tpu_torch.ops import losses, metrics
from pcmseg_tpu_torch.train.steps import align_labels

LOSSES = ("dice", "bce_dice", "tversky", "focal", "focal_dice")
KWARGS = dict(dice_smooth=1.0, bce_weight=0.4, dice_weight=0.6, tversky_alpha=0.3,
              tversky_beta=0.7, focal_gamma=2.0, focal_alpha=0.25)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 6, 5, 4, 1)) * 3).astype(np.float32)
    targets = (rng.random((3, 6, 5, 4, 1)) > 0.6).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_gradient_match_jax(data, name, weighted):
    logits, targets = data
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    jfn = jax_losses.make_loss_fn(name, **KWARGS)
    want, want_g = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(targets), None if w is None else jnp.asarray(w))
    )(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.make_loss_fn(name, **KWARGS)(
        x, torch.from_numpy(targets), None if w is None else torch.from_numpy(w)
    )
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_alone_matches_jax(data, weighted):
    logits, targets = data
    w = np.array([0.0, 1.0, 1.0], np.float32) if weighted else None
    want, want_g = jax.value_and_grad(
        lambda x: jax_losses.bce_loss(x, jnp.asarray(targets), None if w is None else jnp.asarray(w))
    )(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.bce_loss(x, torch.from_numpy(targets), None if w is None else torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-9)


def test_losses_reduce_in_fp32_from_bf16_logits(data):
    logits, targets = data
    got = losses.dice_loss(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(targets))
    assert got.dtype == torch.float32


def test_zero_weight_sample_drops_out_of_the_loss(data):
    logits, targets = data
    w = torch.tensor([1.0, 0.0, 1.0])
    full = losses.dice_loss(torch.from_numpy(logits), torch.from_numpy(targets), weight=w)
    kept = losses.dice_loss(torch.from_numpy(logits[[0, 2]]), torch.from_numpy(targets[[0, 2]]))
    torch.testing.assert_close(full, kept)


def test_unknown_and_unported_losses_raise():
    """An unknown name raises for either head; ``n_classes >= 2``, ported
    since, gives the softmax loss (tests/test_torch_kclass.py holds each
    against JAX)."""
    with pytest.raises(ValueError):
        losses.make_loss_fn("nope")
    with pytest.raises(ValueError):
        losses.make_loss_fn("nope", n_classes=3)
    logits = torch.zeros(1, 4, 4, 4, 3)
    labels = torch.zeros(1, 4, 4, 4, 1, dtype=torch.uint8)
    # uniform softmax over 64 voxels of class 0: Dice of class 0 is
    # (2·64/3 + 1)/(64/3 + 64 + 1), of classes 1 and 2 (0 + 1)/(64/3 + 0 + 1)
    want = 1.0 - ((2 * 64 / 3 + 1) / (64 / 3 + 65) + 2 / (64 / 3 + 1)) / 3
    assert losses.make_loss_fn("dice", n_classes=3)(logits, labels).item() == pytest.approx(want, rel=1e-6)


def test_metrics_match_jax(data):
    logits, targets = data
    pred = (logits > 0).astype(np.float32)
    dice, iou = metrics.per_sample_dice_iou(torch.from_numpy(pred), torch.from_numpy(targets))
    for i in range(3):
        np.testing.assert_allclose(dice[i].item(), float(jax_metrics.dice_score(pred[i], targets[i])), rtol=1e-6)
        np.testing.assert_allclose(iou[i].item(), float(jax_metrics.iou_score(pred[i], targets[i])), rtol=1e-6)
    assert metrics.EPS == jax_metrics.EPS


@pytest.mark.parametrize(
    "label_shape,logit_shape",
    [
        ((2, 32, 32, 32, 1), (2, 16, 16, 16, 1)),  # 32 -> 16
        ((1, 32, 32, 32, 1), (1, 20, 20, 20, 1)),  # 32 -> 20
        ((1, 20, 20, 20, 1), (1, 32, 32, 32, 1)),  # 20 -> 32
        ((1, 20, 32, 17), (1, 32, 20, 32, 1)),  # no channel dim, mixed ratios
        ((1, 16, 16, 16, 1), (1, 16, 16, 16, 1)),  # unchanged
    ],
)
def test_align_labels_matches_jax_nearest_resize(label_shape, logit_shape):
    labels = np.arange(int(np.prod(label_shape)), dtype=np.float32).reshape(label_shape)
    logits = np.zeros(logit_shape, np.float32)
    want = np.asarray(jax_align_labels(jnp.asarray(logits), jnp.asarray(labels)))
    got = align_labels(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)
