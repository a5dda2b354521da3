"""Train and eval steps, the port of ``pcmseg_tpu/train/steps.py``.

Binary heads (sigmoid) and K-class heads (``n_classes >= 2``: softmax over
the K logits, integer label maps of class ids, which keep their integer
dtype through ``align_labels`` and reach the losses' one-hot as class ids).
Models with GroupNorm have no running statistics to move.

With a deep-supervision model (``UNet3D(deep_supervision=True)``) the
training loss is the loss at every decoder scale, weighted ``DS_WEIGHTS``
fine to coarse, each against the labels nearest-resized to its scale
(``steps.py:42-46, 199-224``).

One train step: forward with batch-statistics BatchNorm → loss → backward
→ clip by global norm → Adam with coupled L2 weight decay → EMA, with the
BN running statistics updated by each forward. Every 3³ conv of the forward
and of the backward runs a hand-written kernel on CUDA tensors
(``ops/hybrid_conv.py``).

Optimizer parity with the JAX chain (``steps.py:57-73``):
``clip_by_global_norm → add_decayed_weights → scale_by_adam → −lr``. The
clip is applied to the gradients before ``torch.optim.Adam`` runs, with
optax's formula ``g / ‖g‖ · max_norm`` when ‖g‖ ≥ max_norm (no ``+ 1e-6`` as
in ``clip_grad_norm_``); Adam's ``weight_decay`` adds ``wd·p`` to the clipped
gradient before the moments, which is optax's ``add_decayed_weights`` (coupled
L2, not AdamW). The learning rate lives in the param group.

Metrics stay device tensors so the trainer can fetch a step's loss after
the next step is queued.

Data parallelism (``parallel/``): one path for every process, without a
process group too (P = 1, no collective runs). In a group of P ranks (P = 1
included, where every collective is an identity) each rank's step receives
its rows of the padded global batch (``sharding.local_rows``) and leaves
the same state on every rank. The layout follows the
microbatching (``sharding.microbatch_layout``): (a) when P divides the
microbatch, every microbatch is global: BatchNorm and the loss sum over
every rank's rows (``collectives.synchronized_batch``), and each rank seeds
its backward with 1/P of the replicated loss; (b) when P divides
``accum_steps`` instead, each rank runs its own whole microbatches with no
collective inside, records each BatchNorm forward's statistics instead of
moving the running statistics, and after the last microbatch every rank
replays the running-statistics chain of all microbatches in their global
order (JAX's ``lax.scan`` carry, ``steps.py:264-275``), from the exchanged
per-microbatch statistics. Then one all-reduce sums the gradients
(``collectives.GradientAllReduce``), divided by ``accum_steps``; the norm,
clip, Adam and EMA follow on identical values on every rank. The loss is
the mean of the global microbatch losses, summed in microbatch order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from pcmseg_tpu_torch.models.unet3d import BatchNorm
from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
from pcmseg_tpu_torch.ops.metrics import per_class_dice_iou, per_sample_dice_iou
from pcmseg_tpu_torch.parallel import collectives, multihost, sharding

# deep-supervision loss weights, full resolution first, then the 1/2, 1/4 and
# 1/8 heads: geometric halving normalised to sum to 1 (nnU-Net's scheme)
DS_WEIGHTS = (8 / 15, 4 / 15, 2 / 15, 1 / 15)


@dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer, the
    EMA of the parameters (None when ``ema_decay`` is 0) and the count of
    optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0


def make_optimizer(model: nn.Module, config) -> torch.optim.Adam:
    if config.optimizer != "adam":
        raise ValueError(f"unsupported optimizer: {config.optimizer!r}")
    return torch.optim.Adam(
        model.parameters(),
        lr=config.learning_rate,
        betas=tuple(config.betas),
        eps=config.eps,
        weight_decay=config.weight_decay,
    )


def create_train_state(model: nn.Module, config) -> TrainState:
    ema = None
    if config.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model, config), ema=ema)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group["lr"] = lr


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over the list, as optax's ``global_norm``."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    each g becomes ``g / norm * max_norm`` when ``norm >= max_norm``."""
    clip = norm >= max_norm
    den = torch.where(clip, norm, torch.ones_like(norm))
    num = torch.where(clip, torch.full_like(norm, max_norm), torch.ones_like(norm))
    for g in grads:
        g.div_(den).mul_(num)


def apply_gradients(state: TrainState, max_norm: float) -> torch.Tensor:
    """The optimizer update from each parameter's ``grad``, flax's
    ``TrainState.apply_gradients`` over the JAX optimizer chain: optax's
    clip by global norm when ``max_norm`` > 0, then Adam with coupled L2.
    Counts the step. Returns the global norm before clipping."""
    grads = [p.grad for p in state.model.parameters() if p.requires_grad]
    norm = global_norm(grads)
    if max_norm > 0:
        clip_by_global_norm_(grads, norm, max_norm)
    state.optimizer.step()
    state.step += 1
    return norm


def align_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels shaped like ``logits`` (``steps.py:155-169``): add the trailing
    channel dim if missing, then nearest-resize each differing spatial dim
    with ``jax.image.resize``'s half-pixel rule: source index
    ``floor((i + 0.5) · in / out)``, in exact integer arithmetic."""
    if labels.dim() == logits.dim() - 1:
        labels = labels[..., None]
    for axis in range(1, logits.dim() - 1):
        m, n = labels.shape[axis], logits.shape[axis]
        if m != n:
            idx = (2 * torch.arange(n) + 1) * m // (2 * n)
            labels = labels.index_select(axis, idx.to(labels.device))
    return labels


def unported_training_options(config) -> List[str]:
    """The config's training options that this package has not ported."""
    refused = []
    for name in ("spatial_parallel", "tensor_parallel"):
        if getattr(config, name) > 1:
            refused.append(f"{name}={getattr(config, name)}")
    return refused


def refuse_unported_training(config) -> None:
    refused = unported_training_options(config)
    if refused:
        raise NotImplementedError("not ported to the PyTorch package yet: " + ", ".join(refused))


def _replay_running_stats(norms: List[BatchNorm], logs: List[list], parts: List[torch.Tensor],
                          accum: int, owned: range) -> torch.Tensor:
    """Layout (b): every rank's per-microbatch BatchNorm statistics and
    losses, exchanged exactly, then the running statistics moved through
    all ``accum`` microbatches in their global order, as one process moves
    them. Returns the (accum,) microbatch losses in that order."""
    local = torch.stack([
        torch.cat([parts[i].reshape(1)] + [torch.cat(log[i]) for log in logs]) for i in range(len(owned))
    ])
    table = torch.zeros((accum, local.shape[1]), dtype=local.dtype, device=local.device)
    table[owned.start: owned.stop] = local
    collectives.exchange(table)
    for j in range(accum):
        offset = 1
        for m in norms:
            c = m.num_features
            m.momentum_update(table[j, offset: offset + c], table[j, offset + c: offset + 2 * c])
            offset += 2 * c
    return table[:, 0]


def make_train_step(model: nn.Module, config, loss_fn: Optional[Callable] = None) -> Callable:
    """(state, batch) -> {'loss', 'grad_norm'} (device tensors), updating
    ``state`` in place.

    ``batch`` holds 'image' (N, D, H, W, C), 'label' (N, D, H, W[, 1]) and
    optionally 'weight' (N,) 0/1, which masks padded samples out of the
    loss. With ``accum_steps`` > 1 the batch runs as that many microbatches
    in order, each forward updating the BN running statistics; the gradients
    are summed and divided by ``accum_steps`` and the loss is the mean of
    the microbatch losses (``steps.py:244-276``). ``grad_norm`` is the global
    norm before clipping. In a data-parallel job ``batch`` is this rank's
    rows of the global batch (module docstring).
    """
    refuse_unported_training(config)
    loss_fn = loss_fn or loss_fn_from_config(config)
    accum = max(1, int(config.accum_steps))
    ema_decay = float(config.ema_decay)
    clip = float(config.grad_clip_norm or 0.0)
    world, rank = multihost.process_count(), multihost.process_index()
    sync_grads = collectives.GradientAllReduce(list(model.parameters()))
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def objective(out, labels, weight):
        if not model.deep_supervision:
            return loss_fn(out, align_labels(out, labels), weight)
        logits, aux = out
        total = 0.0
        for w, o in zip(DS_WEIGHTS, (logits, *aux)):
            total = total + w * loss_fn(o, align_labels(o, labels), weight)
        return total

    def data_parallel_loss(images, labels, weight) -> torch.Tensor:
        """This rank's microbatches, forward and backward; the gradients
        still this rank's own (without a process group: every microbatch,
        layout (a) with one rank). Returns the mean of the global
        microbatch losses."""
        layout = sharding.microbatch_layout(images.shape[0] * world, accum, world)
        n_micro = accum if layout == "a" else accum // world
        micro = images.shape[0] // n_micro
        if weight is None and accum > 1:
            # as JAX's scan over microbatches (steps.py:259-263)
            weight = torch.ones(images.shape[0], device=images.device)
        parts = []
        if layout == "b":
            for m in norms:
                m.stat_log = []
        try:
            with collectives.synchronized_batch(layout == "a"):
                scale = collectives.backward_scale()
                for i in range(n_micro):
                    sl = slice(i * micro, (i + 1) * micro)
                    w = None if weight is None else weight[sl]
                    part = objective(model(images[sl]), labels[sl], w)
                    (part * scale).backward()
                    parts.append(part.detach())
        finally:
            logs = [m.stat_log for m in norms]
            for m in norms:
                m.stat_log = None
        if layout == "b":
            owned = sharding.owned_microbatches(accum, world, rank)
            parts = list(_replay_running_stats(norms, logs, parts, accum, owned))
        loss = torch.zeros((), device=images.device)
        for part in parts:
            loss = loss + part
        return loss / accum

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        images = batch["image"]
        labels = align_labels(images[..., :1], batch["label"])
        weight = batch.get("weight")
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss = data_parallel_loss(images, labels, weight)
        sync_grads()
        if accum > 1:
            for p in params:
                p.grad.div_(accum)
        norm = apply_gradients(state, clip)
        if state.ema is not None:
            # Polyak average with tf-style warmup; t counts steps after this one
            t = state.step
            d = min(ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        return {"loss": loss, "grad_norm": norm}

    return train_step


def make_eval_step(
    model: nn.Module, config, loss_fn: Optional[Callable] = None, return_pred: bool = False
) -> Callable:
    """(state, batch) -> {'loss', 'dice', 'iou', 'dice_sum', 'iou_sum',
    'weight_sum'}: the batch loss with the running statistics, and Dice/IoU
    per sample at ``config.threshold`` (``steps.py:389-414``), plus 'pred',
    the uint8 mask, with ``return_pred``. K-class (``steps.py:346-388``):
    the argmax label map is scored per foreground class 1..K−1
    ('dice_class', 'iou_class', (N, K−1)), 'dice' and 'iou' are the means
    over those classes, and 'pred' is the (N, D, H, W, 1) uint8 label map.
    With EMA on (and ``ema_eval``) the averaged parameters are scored;
    ``state`` is read for its ``ema`` only. In a data-parallel job the loss
    and the three sums are over every rank's rows of the global batch, the
    per-sample entries this rank's own."""
    refuse_unported_training(config)
    loss_fn = loss_fn or loss_fn_from_config(config)
    threshold = config.threshold
    n_classes = int(config.n_classes)
    use_ema = config.ema_decay > 0 and config.ema_eval

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        images, weight = batch["image"], batch.get("weight")
        model.eval()
        if use_ema and state.ema is not None:
            logits = torch.func.functional_call(model, state.ema, (images,))
        else:
            logits = model(images)
        out = {}
        if n_classes >= 2:
            # the (N, ..., 1) class map nearest-resized to the logits' grid
            labels = align_labels(logits[..., :1], batch["label"])
            pred = logits.float().argmax(-1, keepdim=True)
            out["dice_class"], out["iou_class"] = per_class_dice_iou(pred, labels, n_classes)
            dice, iou = out["dice_class"].mean(1), out["iou_class"].mean(1)
        else:
            labels = align_labels(logits, batch["label"])
            pred = (torch.sigmoid(logits.float()) > threshold).float()
            dice, iou = per_sample_dice_iou(pred, labels)
        w = weight.float() if weight is not None else torch.ones_like(dice)
        with collectives.synchronized_batch():
            loss = loss_fn(logits, labels, weight)
            sums = collectives.batch_sum(torch.stack([(dice * w).sum(), (iou * w).sum(), w.sum()]))
        out.update(loss=loss, dice=dice, iou=iou, dice_sum=sums[0], iou_sum=sums[1], weight_sum=sums[2])
        if return_pred:
            out["pred"] = pred.to(torch.uint8)
        return out

    return eval_step
