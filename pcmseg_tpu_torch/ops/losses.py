"""Segmentation losses in PyTorch, the port of ``pcmseg_tpu/ops/losses.py``.

Same formulas and reductions as the JAX package (``losses.py:24-361``):
sigmoid (binary head) or softmax over the K channels (``n_classes >= 2``,
integer (N, ..., 1) label maps of class ids 0..K−1) → global flatten over
the whole batch → fp32 sums, whatever the logits' dtype (the sums run over
up to 2 M voxels per sample). Inside ``collectives.synchronized_batch`` every
one of those sums runs over the global batch of all ranks (``batch_sum``),
as JAX's do over a batch sharded on 'data' and 'spatial'; the result is
then the same on every rank. An optional (N,) 0/1 ``weight`` masks padded
samples out: for the overlap losses their probabilities and targets are
zeroed before the sums, for the per-voxel losses the mean runs over the
real samples only: each sample's mean over its voxels (summed over its
D-slabs first, ``spatial_sum``), then the weighted mean over the rows
(``row_sum``).

K-class: per-class soft Dice / Tversky averaged over the classes, softmax
cross-entropy as the analog of BCE, focal cross-entropy. The standalone
'dice' and 'tversky' include the background class; the composites
'bce_dice' (CE + Dice) and 'focal_dice' score the foreground classes only
(``_make_multiclass_loss_fn``, ``losses.py:307-353``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from pcmseg_tpu_torch.parallel.collectives import batch_sum, batch_synchronized, row_sum, spatial_plan, spatial_sum

Tensor = torch.Tensor


def _acc_dtype(x: Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _sample_weight(weight: Tensor, like: Tensor) -> Tensor:
    """(N,) per-sample weight → broadcastable (N, 1, ..., 1)."""
    return weight.reshape((like.shape[0],) + (1,) * (like.dim() - 1)).to(_acc_dtype(like))


def _masked(logits: Tensor, targets: Tensor, weight: Optional[Tensor]):
    if logits.shape != targets.shape:
        raise ValueError(
            f"shape mismatch: logits {tuple(logits.shape)} vs targets {tuple(targets.shape)}"
        )
    probs = torch.sigmoid(logits.to(_acc_dtype(logits)))
    t = targets.to(probs.dtype)
    if weight is not None:
        w = _sample_weight(weight, logits)
        probs = probs * w
        t = t * w
    return probs, t


def _weighted_mean(per_elem: Tensor, weight: Optional[Tensor]) -> Tensor:
    if weight is None:
        if batch_synchronized():
            total, count = batch_sum(torch.stack([per_elem.sum(), per_elem.new_tensor(per_elem.numel())]))
            return total / count
        return per_elem.mean()
    # samples all have the same voxel count, so the masked per-voxel mean is
    # the weighted mean of the per-sample means
    w = weight.to(per_elem.dtype)
    dims = tuple(range(1, per_elem.dim()))
    if spatial_plan() is None:
        per_sample = per_elem.mean(dim=dims)
    else:  # this rank holds one D-slab of each sample
        count = per_elem.new_full((per_elem.shape[0],), per_elem[0].numel())
        total, count = spatial_sum(torch.stack([per_elem.sum(dim=dims), count]))
        per_sample = total / count
    num, den = row_sum(torch.stack([(per_sample * w).sum(), w.sum()]))
    return num / den.clamp_min(1.0)


def _neg_log_pt(logits: Tensor, targets: Tensor):
    """Stable per-voxel BCE with logits: max(x,0) − x·t + log(1 + exp(−|x|))."""
    x = logits.to(_acc_dtype(logits))
    t = targets.to(x.dtype)
    return x, t, F.relu(x) - x * t + torch.log1p(torch.exp(-x.abs()))


def dice_loss(logits: Tensor, targets: Tensor, smooth: float = 1.0, weight=None) -> Tensor:
    """``1 − (2·∩ + smooth) / (Σp + Σt + smooth)`` over the global flatten."""
    probs, t = _masked(logits, targets, weight)
    intersection, psum, tsum = batch_sum(torch.stack([(probs * t).sum(), probs.sum(), t.sum()]))
    return 1.0 - (2.0 * intersection + smooth) / (psum + tsum + smooth)


def bce_loss(logits: Tensor, targets: Tensor, weight=None) -> Tensor:
    """Mean binary cross-entropy with logits (``BCEWithLogitsLoss``)."""
    return _weighted_mean(_neg_log_pt(logits, targets)[2], weight)


def bce_dice_loss(
    logits: Tensor,
    targets: Tensor,
    bce_weight: float = 0.5,
    dice_weight: float = 0.5,
    smooth: float = 1.0,
    weight=None,
) -> Tensor:
    return bce_weight * bce_loss(logits, targets, weight) + dice_weight * dice_loss(
        logits, targets, smooth, weight
    )


def tversky_loss(
    logits: Tensor,
    targets: Tensor,
    alpha: float = 0.3,
    beta: float = 0.7,
    smooth: float = 1.0,
    weight=None,
) -> Tensor:
    """``1 − (TP + s) / (TP + α·FP + β·FN + s)`` over the global flatten."""
    probs, t = _masked(logits, targets, weight)
    tp, psum, tsum = batch_sum(torch.stack([(probs * t).sum(), probs.sum(), t.sum()]))
    fp = psum - tp
    fn = tsum - tp
    return 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def focal_loss(
    logits: Tensor, targets: Tensor, gamma: float = 2.0, alpha: float = 0.25, weight=None
) -> Tensor:
    """Binary focal loss ``−α_t (1 − p_t)^γ log p_t``, mean reduction."""
    _, t, neg_log_pt = _neg_log_pt(logits, targets)
    pt = torch.exp(-neg_log_pt)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    return _weighted_mean(alpha_t * torch.pow(1.0 - pt, gamma) * neg_log_pt, weight)


def focal_dice_loss(
    logits: Tensor,
    targets: Tensor,
    focal_weight: float = 0.5,
    dice_weight: float = 0.5,
    gamma: float = 2.0,
    alpha: float = 0.25,
    smooth: float = 1.0,
    weight=None,
) -> Tensor:
    return focal_weight * focal_loss(logits, targets, gamma, alpha, weight) + dice_weight * dice_loss(
        logits, targets, smooth, weight
    )


# ---- multi-class (n_classes >= 2, softmax) -------------------------------------


def one_hot_targets(labels: Tensor, n_classes: int, dtype: torch.dtype = torch.float32) -> Tensor:
    """(N, ..., 1) or (N, ...) integer class ids → (N, ..., K) one-hot in
    ``dtype``. An id outside 0..K−1 is all zeros, as ``jax.nn.one_hot``
    makes it (a comparison, so no device sync checks the range)."""
    if labels.shape[-1] == 1:
        labels = labels[..., 0]
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.long()[..., None] == classes).to(dtype)


def _softmax_masked(logits: Tensor, labels: Tensor, weight: Optional[Tensor]):
    probs = torch.softmax(logits.to(_acc_dtype(logits)), dim=-1)
    t = one_hot_targets(labels, logits.shape[-1], probs.dtype)
    if weight is not None:
        w = _sample_weight(weight, logits)
        probs = probs * w
        t = t * w
    return probs, t


def _class_mean(per_class: Tensor, include_background: bool) -> Tensor:
    return per_class[0 if include_background else 1:].mean()


def softmax_dice_loss(
    logits: Tensor, labels: Tensor, smooth: float = 1.0, weight=None, include_background: bool = False
) -> Tensor:
    """``1 − mean_c (2·∩_c + s) / (Σp_c + Σt_c + s)`` over the global flatten,
    the mean over classes 1..K−1 (class 0 too with ``include_background``)."""
    probs, t = _softmax_masked(logits, labels, weight)
    axes = tuple(range(probs.dim() - 1))
    inter, psum, tsum = batch_sum(torch.stack([(probs * t).sum(axes), probs.sum(axes), t.sum(axes)]))
    denom = psum + tsum
    return 1.0 - _class_mean((2.0 * inter + smooth) / (denom + smooth), include_background)


def _log_pt(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-voxel log-probability of the true class."""
    logp = torch.log_softmax(logits.to(_acc_dtype(logits)), dim=-1)
    return (one_hot_targets(labels, logits.shape[-1], logp.dtype) * logp).sum(-1)


def ce_loss(logits: Tensor, labels: Tensor, weight=None) -> Tensor:
    """Mean softmax cross-entropy (``CrossEntropyLoss``, mean reduction)."""
    return _weighted_mean(-_log_pt(logits, labels), weight)


def mc_tversky_loss(
    logits: Tensor,
    labels: Tensor,
    alpha: float = 0.3,
    beta: float = 0.7,
    smooth: float = 1.0,
    weight=None,
    include_background: bool = False,
) -> Tensor:
    """``1 − mean_c (TP_c + s) / (TP_c + α·FP_c + β·FN_c + s)``, classes as in
    :func:`softmax_dice_loss`."""
    probs, t = _softmax_masked(logits, labels, weight)
    axes = tuple(range(probs.dim() - 1))
    tp, psum, tsum = batch_sum(torch.stack([(probs * t).sum(axes), probs.sum(axes), t.sum(axes)]))
    fp = psum - tp
    fn = tsum - tp
    return 1.0 - _class_mean((tp + smooth) / (tp + alpha * fp + beta * fn + smooth), include_background)


def mc_focal_loss(logits: Tensor, labels: Tensor, gamma: float = 2.0, weight=None) -> Tensor:
    """``−(1 − p_t)^γ log p_t`` with p_t the softmax probability of the true
    class, mean reduction. The base is clamped to >= 1e-7: a pow lowered as
    exp(γ·log(base)) returns NaN at base 0, which a saturated voxel reaches
    (``losses.py:293-297``)."""
    log_pt = _log_pt(logits, labels)
    base = (1.0 - torch.exp(log_pt)).clamp_min(1e-7)
    return _weighted_mean(-torch.pow(base, gamma) * log_pt, weight)


def _make_multiclass_loss_fn(name: str, **kwargs) -> Callable:
    smooth = kwargs.get("dice_smooth", 1.0)
    if name == "dice":
        return lambda logits, targets, weight=None: softmax_dice_loss(
            logits, targets, smooth, weight, include_background=True
        )
    if name == "bce_dice":  # CE is the K-class analog of BCE
        cw, dw = kwargs.get("bce_weight", 0.5), kwargs.get("dice_weight", 0.5)
        return lambda logits, targets, weight=None: (
            cw * ce_loss(logits, targets, weight) + dw * softmax_dice_loss(logits, targets, smooth, weight)
        )
    if name == "tversky":
        return lambda logits, targets, weight=None: mc_tversky_loss(
            logits, targets, kwargs.get("tversky_alpha", 0.3), kwargs.get("tversky_beta", 0.7),
            smooth, weight, include_background=True,
        )
    if name == "focal":
        return lambda logits, targets, weight=None: mc_focal_loss(
            logits, targets, kwargs.get("focal_gamma", 2.0), weight
        )
    if name == "focal_dice":
        fw, dw = kwargs.get("bce_weight", 0.5), kwargs.get("dice_weight", 0.5)
        g = kwargs.get("focal_gamma", 2.0)
        return lambda logits, targets, weight=None: (
            fw * mc_focal_loss(logits, targets, g, weight) + dw * softmax_dice_loss(logits, targets, smooth, weight)
        )
    raise ValueError(f"unknown loss: {name!r}")


def make_loss_fn(name: str, n_classes: int = 1, **kwargs) -> Callable:
    """Loss factory keyed by config names (``losses.py:356``); with
    ``n_classes >= 2`` each name is its softmax analog. The returned
    function takes (logits, targets, weight=None)."""
    if n_classes >= 2:
        return _make_multiclass_loss_fn(name, **kwargs)
    smooth = kwargs.get("dice_smooth", 1.0)
    if name == "dice":
        return lambda logits, targets, weight=None: dice_loss(logits, targets, smooth, weight)
    if name == "bce_dice":
        return lambda logits, targets, weight=None: bce_dice_loss(
            logits, targets, kwargs.get("bce_weight", 0.5), kwargs.get("dice_weight", 0.5),
            smooth, weight,
        )
    if name == "tversky":
        return lambda logits, targets, weight=None: tversky_loss(
            logits, targets, kwargs.get("tversky_alpha", 0.3), kwargs.get("tversky_beta", 0.7),
            smooth, weight,
        )
    if name == "focal":
        return lambda logits, targets, weight=None: focal_loss(
            logits, targets, kwargs.get("focal_gamma", 2.0), kwargs.get("focal_alpha", 0.25), weight
        )
    if name == "focal_dice":
        return lambda logits, targets, weight=None: focal_dice_loss(
            logits, targets, kwargs.get("bce_weight", 0.5), kwargs.get("dice_weight", 0.5),
            kwargs.get("focal_gamma", 2.0), kwargs.get("focal_alpha", 0.25), smooth, weight,
        )
    raise ValueError(f"unknown loss: {name!r}")


def loss_fn_from_config(config) -> Callable:
    return make_loss_fn(
        config.loss,
        n_classes=config.n_classes,
        dice_smooth=config.dice_smooth,
        bce_weight=config.bce_weight,
        dice_weight=config.dice_weight,
        tversky_alpha=config.tversky_alpha,
        tversky_beta=config.tversky_beta,
        focal_gamma=config.focal_gamma,
        focal_alpha=config.focal_alpha,
    )
