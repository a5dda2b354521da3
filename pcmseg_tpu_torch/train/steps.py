"""Train and eval steps, the port of ``pcmseg_tpu/train/steps.py``.

Binary heads (sigmoid) and K-class heads (``n_classes >= 2``: softmax over
the K logits, integer label maps of class ids, which keep their integer
dtype through ``align_labels`` and reach the losses' one-hot as class ids).
Models with GroupNorm have no running statistics to move.

With a deep-supervision model (``UNet3D(deep_supervision=True)``, or
nnU-Net's ``PlainConvUNet(deep_supervision=True)``) the
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
clip is applied to the gradients before the Adam step runs, with optax's
formula ``g / ‖g‖ · max_norm`` when ‖g‖ ≥ max_norm (no ``+ 1e-6`` as in
``clip_grad_norm_``); Adam's ``weight_decay`` adds ``wd·p`` to the clipped
gradient before the moments, which is optax's ``add_decayed_weights`` (coupled
L2, not AdamW). The learning rate lives in the param group. fp32 parameters
take ``torch.optim.Adam``. 16-bit parameters (``param_dtype`` 'bfloat16' or
'float16': the gradients, the Adam moments and every update in that dtype,
as optax keeps them) take ``Adam16``, which follows optax's operations one
by one with a rounding to the dtype after each, with the learning rate held
in the dtype as ``inject_hyperparams`` holds it; ``global_norm`` then sums
as ``optax.global_norm`` sums 16-bit leaves. The EMA of 16-bit parameters is
fp32, as JAX's is from its first step on (``d`` there is an fp32 array).

Metrics stay device tensors so the trainer can fetch a step's loss after
the next step is queued.

Data and spatial parallelism (``parallel/``): one path for every process,
without a process group too (one rank, no collective runs). In a group
(of one rank too, where every collective is an identity) the step runs on
a data × spatial mesh (``sharding.Mesh``; default: every rank on 'data').
Each rank's step receives its rows of the padded global batch
(``sharding.local_rows``, by its data coordinate) and, on a spatial mesh,
its D-slab of them (``sharding.cut_d_slab``, by its spatial coordinate;
a batch of whole rows is cut here), and leaves the same state on every
rank. The layout follows the microbatching over the P data ranks
(``sharding.microbatch_layout``): (a) when P divides the microbatch, every
microbatch is global: BatchNorm and the loss sum over every rank's part
(``collectives.synchronized_batch``), and each rank seeds its backward
with 1/world of the replicated loss; (b) when P divides ``accum_steps``
instead, each data rank runs its own whole microbatches, synchronised
only with the other D-slabs of its rows (seeding 1/spatial), records each
BatchNorm forward's statistics instead of moving the running statistics,
and after the last microbatch every rank replays the running-statistics
chain of all microbatches in their global order (JAX's ``lax.scan``
carry, ``steps.py:264-275``), from the per-microbatch statistics
exchanged over the data ranks; (c) when P divides neither, the data ranks
form groups of q = P / gcd(P, A), each group runs its own block of
microbatches as (a) runs all of them, synchronised over the group (the
microbatch group: its data ranks times the spatial ranks), and the
running statistics are replayed as in (b). Then one all-reduce over every rank sums
the gradients (``collectives.GradientAllReduce``: other rows' and other
slabs' partial sums alike), divided by ``accum_steps``; the norm, clip,
Adam and EMA follow on identical values on every rank. With 16-bit
parameters, where a microbatch spans ranks (its D-slabs, or in layout (a)
its rows), its gradients stay fp32 until one all-reduce a microbatch has
summed them over those ranks, and only then round to the parameters' dtype
and add up in it, in JAX's order (``_fp32_backward``); in layouts (b) and
(c) the groups' sums (one rank's of each group) are then summed over the
data ranks. The loss is the
mean of the global microbatch losses, summed in microbatch order.

On a spatial mesh the forward and the loss run under a
``collectives.spatial`` plan (``models/unet3d.py``: halo convs, gathered
deep levels). Each output is scored on the rows this rank owns: its slab
at a sharded level; at a replicated level (a deep-supervision head) the
rows whose nearest label voxel lies in its label slab (``slab_targets``,
JAX's index rule on global coordinates, on the labels gathered whole), so
the ranks' loss terms are disjoint and their sums over the group are the
whole loss.

On a mesh with a model axis (tensor parallelism) the model holds this
rank's output-channel shards (``sharding.shard_state``); every rank of a
model group receives the same rows and D-slab, and the forward's logits,
the loss and the metrics are whole and equal on each of them. The batch
sums above then run over the ranks that hold the same channels (the
replica group: every rank without a model axis), so a rank seeds its
backward with 1/(data·spatial), and one all-reduce over that group sums
the gradients of this rank's shards and of the replicated parameters.
The clip's global norm sums the sharded gradients' squares over the model
group (``sharded_global_norm``); Adam's moments and the EMA are per shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pcmseg_tpu_torch.models.unet3d import BatchNorm
from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
from pcmseg_tpu_torch.ops.metrics import per_class_dice_iou, per_sample_dice_iou
from pcmseg_tpu_torch.parallel import collectives, multihost, sharding
from pcmseg_tpu_torch.parallel.collectives import SpatialPlan
from pcmseg_tpu_torch.train.checkpoints import jax_leaf_path
from pcmseg_tpu_torch.utils.profiling import span

# deep-supervision loss weights, full resolution first, then the 1/2, 1/4 and
# 1/8 heads: geometric halving normalised to sum to 1 (nnU-Net's scheme)
DS_WEIGHTS = (8 / 15, 4 / 15, 2 / 15, 1 / 15)
# SGD's momentum under optimizer='sgd', as nnU-Net's nnUNetTrainer fixes it
NNUNET_MOMENTUM = 0.99


@dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer, the
    EMA of the parameters (None when ``ema_decay`` is 0) and the count of
    optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0


LOW_PRECISION = (torch.bfloat16, torch.float16)


class Adam16(torch.optim.Optimizer):
    """optax's ``add_decayed_weights → scale_by_adam → scale(−1) →
    scale(lr)`` then ``apply_updates``, for parameters in a 16-bit dtype T,
    with optax's arithmetic: every operation in T, rounded to T as it is
    computed, the Python-float constants (wd, b1, 1 − b1, b2, 1 − b2, eps)
    rounded to T first as JAX's weak types round them, the bias corrections
    ``1 − b^count`` computed in fp32 from the int32 count and then cast to
    T (``tree_bias_correction``), and the learning rate held in T
    (``inject_hyperparams`` casts it to the params' dtype): get and set it
    through ``round`` so that the param group holds that value. Moments
    ``mu`` and ``nu`` are in T; each parameter's state keeps the int32
    count as 'step' (on the CPU, as ``torch.optim.Adam`` keeps its own).

    bf16 follows XLA's arithmetic on the CPU bit for bit (measured on given
    gradients over 3 steps, clipped and not): it rounds after every
    operation. fp16 follows XLA's fused CPU code as its HLO reads: of each
    sum of two products, LLVM fuses one product with the sum into one fp32
    fma (``_fused``: ``g·(1 − b1)`` is rounded and ``b1·mu`` fused, ``b2·nu``
    rounded and ``g²·(1 − b2)`` fused), and the update's
    ``(mu / bc1) / den`` is ``mu / (bc1 · den)``. bf16's path would put
    fp16 parameters up to 6 ulps from XLA's after one step
    (``tests/test_torch_param_dtype.py`` gives the readings).

    ``order``: the parameters in the order in which ``apply_gradients``
    sums their gradients' norm (``jax_order``; by default as given)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 order: Optional[List[nn.Parameter]] = None):
        params = list(params)
        self.order = params if order is None else order
        self.dtype = params[0].dtype
        if self.dtype not in LOW_PRECISION or any(p.dtype != self.dtype for p in params):
            raise TypeError(f"Adam16 takes parameters of one 16-bit dtype, got {sorted({str(p.dtype) for p in params})}")
        super().__init__(params, dict(lr=self.round(lr), betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    def round(self, value: float) -> float:
        """``value`` as a hyperparameter in the parameters' dtype holds it."""
        return float(torch.tensor(value, dtype=self.dtype))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam16 takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            consts = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                key = p.device
                if key not in consts:
                    t = lambda v: torch.tensor(v, dtype=p.dtype, device=p.device)  # noqa: E731
                    consts[key] = (t(wd), t(b1), t(1 - b1), t(b2), t(1 - b2), t(group["eps"]), t(group["lr"]))
                c_wd, c_b1, c_1b1, c_b2, c_1b2, c_eps, c_lr = consts[key]
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int32)
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                g = p.grad
                fma = _fused if p.dtype == torch.float16 else _unfused
                if wd > 0:
                    g = fma(c_wd, p, g)
                mu = state["mu"]
                mu.copy_(fma(c_b1, mu, g * c_1b1))
                nu = state["nu"]
                nu.copy_(fma(c_1b2, g * g, nu * c_b2))
                state["step"] += 1
                key = (p.device, int(state["step"]))
                if key not in consts:
                    count = state["step"].float()
                    consts[key] = [(1 - torch.tensor(b, dtype=torch.float32) ** count).to(p.device, p.dtype)
                                   for b in (b1, b2)]
                bc1, bc2 = consts[key]
                if p.dtype == torch.float16:
                    # XLA rewrites (mu / bc1) / den as mu / (bc1 · den) there
                    p.copy_(fma(mu / (bc1 * (torch.sqrt(nu / bc2) + c_eps)), -c_lr, p))
                else:
                    p.add_(c_lr * -((mu / bc1) / (torch.sqrt(nu / bc2) + c_eps)))
        return None


def _unfused(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c with the product rounded to the dtype, then the sum: XLA's
    bf16 arithmetic, which rounds after every operation."""
    return a * b + c


def _fused(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once from fp32: XLA's fp16 arithmetic on the CPU,
    where LLVM contracts a multiply feeding an add into one fp32 fma (the
    product of two fp16 values is exact in fp32)."""
    return (a.float() * b.float() + c.float()).to(c.dtype)


def make_optimizer(model: nn.Module, config) -> torch.optim.Optimizer:
    """Adam with coupled L2 from the config: ``torch.optim.Adam`` for fp32
    parameters, ``Adam16`` for 16-bit ones. With ``optimizer='sgd'``
    ``torch.optim.SGD`` over the trainable parameters (Nesterov, momentum
    ``NNUNET_MOMENTUM``, coupled ``weight_decay``: nnU-Net's), fp32 ones only."""
    params = list(model.parameters())
    if config.optimizer == "sgd":
        if any(p.dtype in LOW_PRECISION for p in params):
            raise NotImplementedError("optimizer='sgd' takes fp32 parameters (param_dtype='float32')")
        return torch.optim.SGD([p for p in params if p.requires_grad], lr=config.learning_rate,
                               momentum=NNUNET_MOMENTUM, nesterov=True,
                               weight_decay=config.weight_decay)
    if config.optimizer != "adam":
        raise ValueError(f"unsupported optimizer: {config.optimizer!r}")
    kwargs = dict(lr=config.learning_rate, betas=tuple(config.betas), eps=config.eps,
                  weight_decay=config.weight_decay)
    if params and params[0].dtype in LOW_PRECISION:
        return Adam16(params, order=jax_order(model), **kwargs)
    return torch.optim.Adam(params, **kwargs)


def jax_order(model: nn.Module) -> List[nn.Parameter]:
    """``model``'s trainable parameters in ``jax.tree.leaves``' order of the
    JAX package's tree (``checkpoints.jax_leaf_path``): the order in which
    ``optax.global_norm`` sums 16-bit leaves."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return [p for _, p in sorted(named, key=lambda kv: jax_leaf_path(kv[0]))]


def create_train_state(model: nn.Module, config) -> TrainState:
    ema = None
    if config.ema_decay > 0:
        # fp32 for 16-bit parameters: JAX's EMA leaves are fp32 from its
        # first step on (its init copy holds the same values in bf16)
        ema = {k: p.detach().clone() if p.dtype not in LOW_PRECISION else p.detach().float()
               for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model, config), ema=ema)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> None:
    if isinstance(state.optimizer, Adam16):
        lr = state.optimizer.round(lr)
    for group in state.optimizer.param_groups:
        group["lr"] = lr


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(t * t)`` of a 16-bit leaf: the squares rounded to its
    dtype, their sum accumulated in fp32 (returned in fp32: the caller
    rounds it to the dtype once)."""
    return (t * t).float().sum()


def _sum_in_order(sums: List[torch.Tensor]) -> torch.Tensor:
    """``sum(sums)`` as Python's ``sum`` adds them: left to right, each
    addition in the leaves' dtype."""
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over the list, as optax's ``global_norm``: of fp32
    leaves with fp32 sums; of 16-bit leaves in their dtype, as optax sums
    them (each leaf's squares summed, the leaves' sums added in the list's
    order, which for optax's result is ``jax.tree.leaves``' order, and the
    square root taken, each in the dtype)."""
    if tensors[0].dtype in LOW_PRECISION:
        return torch.sqrt(_sum_in_order([_square_sum(t).to(t.dtype) for t in tensors]))
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    each g becomes ``g / norm * max_norm`` when ``norm >= max_norm``."""
    clip = norm >= max_norm
    den = torch.where(clip, norm, torch.ones_like(norm))
    num = torch.where(clip, torch.full_like(norm, max_norm), torch.ones_like(norm))
    for g in grads:
        g.div_(den).mul_(num)


def sharded_global_norm(model: nn.Module, order: Optional[List[nn.Parameter]] = None) -> Optional[torch.Tensor]:
    """The global norm of the gradients of a tensor-parallel ``model``
    (``sharding.shard_model``), the same on every rank: the squares of the
    sharded parameters' gradients summed over the model group, those of the
    replicated ones (whole on every rank) counted once. 16-bit gradients
    are summed in ``order``, the parameters in ``jax.tree.leaves``' order
    (``jax_order``), which they need. None for a model without shards."""
    comm, leaves = None, []  # (parameter, sharded)
    for m in model.modules():
        tp = getattr(m, "tp", None)
        sharded = tp is not None and tp.sharded
        comm = tp.comm if sharded else comm
        leaves += [(p, sharded) for p in m.parameters(recurse=False) if p.requires_grad]
    if comm is None:
        return None
    if leaves[0][0].dtype in LOW_PRECISION:
        if order is None:
            raise ValueError("the norm of 16-bit gradients needs the parameters' order (jax_order)")
        # optax's order in the leaves' dtype: a sharded leaf's fp32 sum of
        # squares summed over the group, then rounded once as a whole leaf's
        of_shards = {id(p) for p, sharded in leaves if sharded}
        sums = [_square_sum(p.grad) for p in order]
        sharded = [i for i, p in enumerate(order) if id(p) in of_shards]
        total = comm.all_reduce(torch.stack([sums[i] for i in sharded]))
        for i, t in zip(sharded, total.unbind()):
            sums[i] = t
        return torch.sqrt(_sum_in_order([t.to(order[0].dtype) for t in sums]))
    squares = lambda grads: torch.stack([torch.linalg.vector_norm(g).square() for g in grads]).sum()  # noqa: E731
    total = comm.all_reduce(squares([p.grad for p, sharded in leaves if sharded]))
    whole = [p.grad for p, sharded in leaves if not sharded]
    return torch.sqrt(total + squares(whole)) if whole else torch.sqrt(total)


def apply_gradients(state: TrainState, max_norm: float) -> torch.Tensor:
    """The optimizer update from each parameter's ``grad``, flax's
    ``TrainState.apply_gradients`` over the JAX optimizer chain: optax's
    clip by global norm when ``max_norm`` > 0, then Adam with coupled L2.
    Counts the step. Returns the global norm before clipping (of the whole
    gradient on a tensor-parallel model: ``sharded_global_norm``)."""
    grads = [p.grad for p in state.model.parameters() if p.requires_grad]
    order = state.optimizer.order if isinstance(state.optimizer, Adam16) else None
    norm = sharded_global_norm(state.model, order)
    if norm is None:
        norm = global_norm(grads if order is None else [p.grad for p in order])
    if max_norm > 0:
        clip_by_global_norm_(grads, norm, max_norm)
    state.optimizer.step()
    state.step += 1
    return norm


def align_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels shaped like ``logits`` (``steps.py:155-169``): add the trailing
    channel dim if missing, then nearest-resize each differing spatial dim
    with ``jax.image.resize``'s half-pixel rule: source index
    ``floor((i + 0.5) · in / out)``, in exact integer arithmetic, on the
    labels' device (an index copied from the host would wait for the card:
    three heads of deep supervision made nine such waits a step)."""
    if labels.dim() == logits.dim() - 1:
        labels = labels[..., None]
    for axis in range(1, logits.dim() - 1):
        m, n = labels.shape[axis], logits.shape[axis]
        if m != n:
            idx = (2 * torch.arange(n, device=labels.device) + 1) * m // (2 * n)
            labels = labels.index_select(axis, idx)
    return labels


def slab_targets(out: torch.Tensor, labels: torch.Tensor, plan: SpatialPlan, level: int):
    """(the D-rows of ``out``, an output at U-Net ``level``, that this rank
    scores; their labels) on a spatially sharded rank, from ``labels``, the
    whole D of its rows. Row i of the level's whole D takes the label of
    voxel ``floor((i + 0.5) · D / D_level)``, :func:`align_labels`' rule on
    global coordinates. ``out`` holds the level's slab where the level is
    sharded, all of which this rank scores; the whole D where it runs
    replicated, of which this rank scores the rows whose voxel lies in its
    level-0 slab, so that the ranks' rows tile the level."""
    depth, (start, stop) = plan.depth(0), plan.slab(level)
    if out.shape[1] != stop - start or labels.shape[1] != depth:
        raise ValueError(f"an output of D={out.shape[1]} at level {level} (the plan holds [{start}, {stop})) "
                         f"and labels of D={labels.shape[1]} (the volume's D is {depth})")
    src = (2 * torch.arange(start, stop) + 1) * depth // (2 * plan.depth(level))
    if not plan.sharded(level):
        s0, e0 = plan.slab(0)
        owned = ((src >= s0) & (src < e0)).tolist()  # src grows with i: one run of rows
        a = owned.index(True) if any(owned) else 0
        out, src = out[:, a: a + sum(owned)], src[a: a + sum(owned)]
    if labels.dim() == out.dim() - 1:
        labels = labels[..., None]
    labels = labels.index_select(1, src.to(labels.device))
    return out, align_labels(out, labels)


def _replay_running_stats(norms: List[BatchNorm], logs: List[list], parts: List[torch.Tensor],
                          accum: int, owned: range, comm, write: bool = True) -> torch.Tensor:
    """Layouts (b) and (c): every group's per-microbatch BatchNorm
    statistics and losses, written by one rank of the group (``write``)
    and exchanged exactly over ``comm`` (the data ranks), then the running
    statistics moved through all ``accum`` microbatches in their global
    order, as one process moves them. Returns the (accum,) microbatch
    losses in that order."""
    local = torch.stack([
        torch.cat([parts[i].reshape(1)] + [torch.cat(log[i]) for log in logs]) for i in range(len(owned))
    ])
    table = torch.zeros((accum, local.shape[1]), dtype=local.dtype, device=local.device)
    if write:
        table[owned.start: owned.stop] = local
    collectives.exchange(table, comm)
    for j in range(accum):
        offset = 1
        for m in norms:
            c = m.num_features
            m.momentum_update(table[j, offset: offset + c], table[j, offset + c: offset + 2 * c])
            offset += 2 * c
    return table[:, 0]


def _fp32_backward(params: List[nn.Parameter], microbatch: Callable[[], torch.Tensor],
                   comm: collectives.Comm, sync: collectives.GradientAllReduce) -> torch.Tensor:
    """``microbatch()`` (a forward and backward, returning its loss) with
    each parameter holding its 16-bit values in fp32 meanwhile, so that
    autograd leaves its gradient in fp32; those gradients summed over
    ``comm`` (the ranks holding the other parts of the microbatch), then
    rounded to the parameter's dtype once and added to its ``.grad`` in that
    dtype. That is JAX's order: GSPMD sums a microbatch's fp32 partial
    gradients over the devices before the cast back to the parameter's
    dtype, and the microbatch scan adds the rounded gradients in that dtype
    (``steps.py:264-269``). Returns the loss."""
    saved = [(p, p.data, p.grad) for p in params]
    try:
        for p, data, _ in saved:
            p.grad = None
            p.data = data.float()
        part = microbatch()
        grads = [p.grad for p in params]
    finally:
        for p, data, grad in saved:
            p.grad = None
            p.data = data
            p.grad = grad
    sync(grads, comm)
    for p, g in zip(params, grads):
        g = g.to(p.dtype)
        if p.grad is None:
            p.grad = g
        else:
            p.grad.add_(g)
    return part


class _MeshStep:
    """What a step knows of its mesh: the groups of this rank (None without
    a process group), its data coordinate, and the D-slab plan of a batch."""

    def __init__(self, config, mesh: Optional[sharding.Mesh]):
        active = collectives.active()
        if mesh is None:
            mesh = (sharding.make_mesh(-1, config.spatial_parallel, config.tensor_parallel) if active
                    else sharding.Mesh())
        if not active and mesh.size > 1:
            raise ValueError(f"a {mesh.data}x{mesh.spatial}x{mesh.model} mesh needs a process group of "
                             f"{mesh.size} ranks")
        self.mesh = mesh
        self.comms = collectives.mesh_comms(mesh) if active else None
        self.data_index = (
            multihost.mesh_coordinates(multihost.process_index(), mesh.data, mesh.spatial, mesh.model)[0]
            if active else 0
        )
        self._levels: Dict[int, sharding.LevelPlan] = {}
        self.group_size = 1  # q of layout (c), set by the train step

    def slab_plan(self, batch: dict):
        """(the batch as this rank holds it, its ``SpatialPlan`` or None): on
        a spatial mesh a batch of whole rows is cut to this rank's slab."""
        if self.mesh.spatial == 1:
            return batch, None
        if sharding.D_SLAB not in batch:
            batch = sharding.cut_d_slab(batch, self.mesh)
        start, stop, depth = batch[sharding.D_SLAB]
        if depth not in self._levels:
            self._levels[depth] = sharding.level_plan(depth, self.mesh.spatial)
        plan = SpatialPlan(self.comms.spatial, self._levels[depth])
        if plan.slab(0) != (start, stop):
            raise ValueError(f"a batch of D-slab [{start}, {stop}) on the rank of slab {plan.slab(0)}")
        return batch, plan

    def microbatch_comm(self, layout: str) -> Optional[collectives.Comm]:
        """The ranks that each hold a part of every microbatch in
        ``layout`` (the batch group of :meth:`synchronized`), or None
        where this rank holds its microbatches whole."""
        if self.comms is None:
            return None
        comm = {"a": self.comms.replica, "b": self.comms.spatial}.get(layout) or self._microbatch()[0]
        return comm if comm.size > 1 else None

    def _microbatch(self):
        """Layout (c): this rank's microbatch group and its rows
        (``collectives.microbatch_comms``; the groups are made once, at the
        first step that every rank runs in this layout)."""
        return collectives.microbatch_comms(self.mesh, self.group_size)

    def synchronized(self, layout: str = "a"):
        """The ``synchronized_batch`` of a microbatch in ``layout``: (a) the
        voxels over every rank that holds the same channels (every rank
        without a model axis) and the samples over the data ranks; (b) the
        voxels over the other D-slabs only (none without them); (c) the
        voxels over the microbatch group and the samples over its data
        ranks."""
        if self.comms is None:
            return collectives.synchronized_batch(False)
        if layout == "a":
            return collectives.synchronized_batch(batch=self.comms.replica, rows=self.comms.data)
        if layout == "c":
            batch, rows = self._microbatch()
            return collectives.synchronized_batch(batch=batch, rows=rows)
        return collectives.synchronized_batch(self.mesh.spatial > 1, batch=self.comms.spatial)


def update_ema(state: TrainState, model: nn.Module, ema_decay: float) -> None:
    """The Polyak average of the parameters after a step, with tf-style
    warmup (t counts the steps after this one)."""
    t = state.step
    d = min(ema_decay, (1.0 + t) / (10.0 + t))
    d32 = np.float32(d)
    with torch.no_grad():
        for name, p in model.named_parameters():
            e = state.ema[name]
            if e.dtype == p.dtype:
                e.mul_(d).add_(p, alpha=1.0 - d)
            else:  # an fp32 EMA of 16-bit params: JAX's fp32 d·e + (1 − d)·p
                e.mul_(float(d32)).add_(p.float().mul_(float(np.float32(1.0) - d32)))


def make_train_step(
    model: nn.Module, config, loss_fn: Optional[Callable] = None, mesh: Optional[sharding.Mesh] = None
) -> Callable:
    """(state, batch) -> {'loss', 'grad_norm'} (device tensors), updating
    ``state`` in place.

    ``batch`` holds 'image' (N, D, H, W, C), 'label' (N, D, H, W[, 1]) and
    optionally 'weight' (N,) 0/1, which masks padded samples out of the
    loss. With ``accum_steps`` > 1 the batch runs as that many microbatches
    in order, each forward updating the BN running statistics; the gradients
    are summed and divided by ``accum_steps`` and the loss is the mean of
    the microbatch losses (``steps.py:244-276``). ``grad_norm`` is the global
    norm before clipping. In a job of several ranks ``batch`` is this
    rank's rows of the global batch, whole or its D-slab of them, on
    ``mesh`` (module docstring).
    """
    loss_fn = loss_fn or loss_fn_from_config(config)
    accum = max(1, int(config.accum_steps))
    ema_decay = float(config.ema_decay)
    clip = float(config.grad_clip_norm or 0.0)
    on = _MeshStep(config, mesh)
    dp = on.mesh.data
    sync_grads = collectives.GradientAllReduce(list(model.parameters()), on.comms.replica if on.comms else None)
    params = sync_grads.params
    low_precision = any(p.dtype in LOW_PRECISION for p in params)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def objective(out, labels, weight, plan):
        if not model.deep_supervision:
            return loss_fn(out, align_labels(out, labels), weight)
        logits, aux = out
        # a rank scores a coarse head on rows whose labels may lie in other slabs
        whole = collectives.gather_d(labels, plan, 0) if plan is not None else None
        total = 0.0
        for level, (w, o) in enumerate(zip(DS_WEIGHTS, (logits, *aux))):
            if plan is None or level == 0:  # level 0: the output's slab is the labels'
                o, t = o, align_labels(o, labels)
            else:
                o, t = slab_targets(o, whole, plan, level)
            total = total + w * loss_fn(o, t, weight)
        return total

    def data_parallel_loss(images, labels, weight, plan) -> torch.Tensor:
        """This rank's microbatches, forward and backward, and the gradients
        summed over the ranks (without a process group: every microbatch,
        layout (a) with one rank). Returns the mean of the global
        microbatch losses."""
        layout = sharding.microbatch_layout(images.shape[0] * dp, accum, dp)
        owned = sharding.owned_microbatches(accum, dp, on.data_index, layout)
        micro = images.shape[0] // len(owned)
        # layout (c): the q data ranks of a microbatch group; the first of
        # them writes the group's statistics and fp32-summed gradients once
        on.group_size = sharding.group_size(accum, dp) if layout == "c" else 1
        first = on.data_index % on.group_size == 0
        # 16-bit parameters whose microbatches span ranks: each microbatch's
        # fp32 gradients summed over them before the rounding (_fp32_backward)
        spans = on.microbatch_comm(layout) if low_precision else None
        if weight is None and accum > 1:
            # as JAX's scan over microbatches (steps.py:259-263)
            weight = torch.ones(images.shape[0], device=images.device)
        parts = []
        if layout != "a":
            for m in norms:
                m.stat_log = []
        try:
            with on.synchronized(layout), collectives.spatial(plan):
                scale = collectives.backward_scale()
                for i in range(len(owned)):
                    sl = slice(i * micro, (i + 1) * micro)
                    w = None if weight is None else weight[sl]

                    def microbatch():
                        with span("train.forward"):
                            part = objective(model(images[sl]), labels[sl], w, plan)
                        with span("train.backward"):
                            (part * scale).backward()
                        return part.detach()

                    parts.append(microbatch() if spans is None
                                 else _fp32_backward(params, microbatch, spans, sync_grads))
        finally:
            logs = [m.stat_log for m in norms]
            for m in norms:
                m.stat_log = None
        if spans is None:
            sync_grads()
        elif layout != "a" and dp > 1:  # each group's sums of its own microbatches
            if not first:
                for p in params:
                    p.grad.zero_()
            sync_grads(comm=on.comms.data)
        if layout != "a":
            data_comm = on.comms.data if on.comms is not None else None
            parts = list(_replay_running_stats(norms, logs, parts, accum, owned, data_comm, first))
        loss = torch.zeros((), device=images.device)
        for part in parts:
            loss = loss + part
        return loss / accum

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("train.step", state.step):
            batch, plan = on.slab_plan(batch)
            images = batch["image"]
            labels = align_labels(images[..., :1], batch["label"])
            weight = batch.get("weight")
            model.train()
            for p in params:
                p.grad = None
            loss = data_parallel_loss(images, labels, weight, plan)
            with span("train.optimizer"):
                if accum > 1:
                    for p in params:
                        p.grad.div_(accum)
                norm = apply_gradients(state, clip)
                if state.ema is not None:
                    update_ema(state, model, ema_decay)
        return {"loss": loss, "grad_norm": norm}

    return train_step


def make_eval_step(
    model: nn.Module,
    config,
    loss_fn: Optional[Callable] = None,
    return_pred: bool = False,
    mesh: Optional[sharding.Mesh] = None,
) -> Callable:
    """(state, batch) -> {'loss', 'dice', 'iou', 'dice_sum', 'iou_sum',
    'weight_sum'}: the batch loss with the running statistics, and Dice/IoU
    per sample at ``config.threshold`` (``steps.py:389-414``), plus 'pred',
    the uint8 mask, with ``return_pred``. K-class (``steps.py:346-388``):
    the argmax label map is scored per foreground class 1..K−1
    ('dice_class', 'iou_class', (N, K−1)), 'dice' and 'iou' are the means
    over those classes, and 'pred' is the (N, D, H, W, 1) uint8 label map.
    With EMA on (and ``ema_eval``) the averaged parameters are scored;
    ``state`` is read for its ``ema`` only. In a job of several ranks the
    loss and the three sums are over every rank's rows of the global batch,
    the per-sample entries those of this rank's rows (summed over their
    D-slabs on a spatial ``mesh``; 'pred' this rank's slab)."""
    loss_fn = loss_fn or loss_fn_from_config(config)
    threshold = config.threshold
    n_classes = int(config.n_classes)
    use_ema = config.ema_decay > 0 and config.ema_eval
    on = _MeshStep(config, mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch, plan = on.slab_plan(batch)
        with collectives.spatial(plan):
            return scores(state, batch)

    def scores(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
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
        with on.synchronized():
            loss = loss_fn(logits, labels, weight)
            sums = collectives.row_sum(torch.stack([(dice * w).sum(), (iou * w).sum(), w.sum()]))
        out.update(loss=loss, dice=dice, iou=iou, dice_sum=sums[0], iou_sum=sums[1], weight_sum=sums[2])
        if return_pred:
            out["pred"] = pred.to(torch.uint8)
        return out

    return eval_step
