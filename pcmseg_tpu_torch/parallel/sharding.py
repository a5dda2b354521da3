"""The ('data', 'spatial', 'model') mesh over the ranks, the rows of a
global batch each rank trains, the D-slab of those rows it holds and its
shards of the model: the port of ``pcmseg_tpu/parallel/sharding.py:35-128``.

One rank is one process on one card. ``data`` ranks train disjoint rows of
each global batch; BatchNorm and the loss sum over the global batch
(``collectives``), as GSPMD made them in JAX, and the gradients are summed
by one all-reduce a step. ``spatial`` ranks hold the same rows, each a
slab of the volume's D axis (:func:`level_plan`). ``model`` ranks hold the
same rows and slab, each the output-channel shards of every leaf that
JAX's rule by shape shards (:func:`param_spec`, mapped to the port's
layouts by :func:`shard_axis`; the state cut by :func:`shard_state`, the
checkpoints joined by :func:`whole_payload`). The ranks of a mesh are
ordered as JAX's (``multihost.mesh_coordinates``): rank ``(d·spatial +
s)·model + m`` holds rows ``d``, slab ``s`` and shard ``m``.

A padded global batch of B rows, run as A microbatches of m = B / A rows
(JAX's ``lax.scan`` over ``reshape(A, m, ...)``), is spread over P data
ranks in one of three layouts (:func:`microbatch_layout`):

  (a) P divides m: every rank holds m / P rows of every microbatch, and
      BatchNorm and the loss are synchronised inside each microbatch;
  (b) P divides A: every rank runs A / P whole microbatches, the
      contiguous block ``rank·A/P .. (rank+1)·A/P − 1``, with no collective
      between data ranks inside a microbatch;
  (c) neither: with g = gcd(P, A) and q = P / g, the ranks form g groups
      of q (group j = rank // q); group j runs the A / g microbatches
      ``j·A/g .. (j+1)·A/g − 1``, each of its ranks m / q rows of each, and
      BatchNorm and the loss are synchronised over the group (the
      microbatch group, ``multihost.mesh_groups``). The padded B is a
      multiple of lcm(P, A) = P·A / g, so q divides m. (a) is the case
      g = 1 and (b) the case q = 1; JAX's contiguous data sharding groups
      the ranks so (at P = 4, A = 2 microbatch 0 is rows 0-1 on ranks 0-1).

:func:`local_rows` gives a rank's rows in the order its step runs them, so
a loader or a gather hands each rank exactly those rows. With A = 1 it is
the contiguous slice ``rank·B/P .. (rank+1)·B/P − 1``, JAX's
``process_shard``.

D-slabs (:func:`d_slabs`, :func:`level_plan`): the D voxels of the input
are dealt out in whole pairs, as evenly as they go, so every slab but the
last is even and starts at an even index and 2³ max-pooling stays inside
a slab; the level below then holds the halved slabs. A level runs sharded
while its slabs came from such a pooling; from the first level where a
slab would start at an odd index (16³ over 4 ranks: level 3; 18³ over 2:
level 2) the activations are gathered whole onto every rank of the
spatial group, and the deeper levels run replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from pcmseg_tpu_torch.parallel import multihost

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
# the key of a batch whose arrays hold one D-slab of their rows: (start, stop, depth)
D_SLAB = "d_slab"
LEVELS = 5  # the U-Net's resolutions: the input's and four pooled ones


@dataclass(frozen=True)
class Mesh:
    """Sizes of the three axes over the job's ranks."""

    data: int = 1
    spatial: int = 1
    model: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.spatial * self.model


def make_mesh(
    data_parallel: int = -1,
    spatial_parallel: int = 1,
    model_parallel: int = 1,
    world: Optional[int] = None,
) -> Mesh:
    """The mesh over ``world`` ranks (default: the job's process count), by
    JAX's rules: ``data_parallel=-1`` takes every rank the other axes leave;
    an indivisible or oversized mesh raises ``ValueError``."""
    n = multihost.process_count() if world is None else int(world)
    if spatial_parallel < 1 or model_parallel < 1:
        raise ValueError("spatial_parallel/model_parallel must be >= 1")
    other = spatial_parallel * model_parallel
    if data_parallel == -1:
        if n % other:
            raise ValueError(f"{n} devices not divisible by spatial*model={other}")
        data_parallel = n // other
    if data_parallel < 1:
        raise ValueError(f"data_parallel={data_parallel} must be >= 1 or -1")
    if data_parallel * other > n:
        raise ValueError(
            f"mesh {data_parallel}x{spatial_parallel}x{model_parallel} needs more than {n} devices"
        )
    return Mesh(data_parallel, spatial_parallel, model_parallel)


def padded_batch_size(batch_size: int, data: int, processes: int, accum: int) -> int:
    """The size every batch pads to: the smallest multiple of
    lcm(data-parallel ranks, processes, ``accum``) that holds
    ``batch_size`` (``trainer.py:127-136``)."""
    q = math.lcm(data, processes, max(1, int(accum)))
    return -(-batch_size // q) * q


def microbatch_layout(global_batch: int, accum: int, world: int) -> str:
    """'a', 'b' or 'c' (module docstring) for a padded global batch of
    ``global_batch`` rows in ``accum`` microbatches over ``world`` ranks;
    'a' when both (a) and (b) fit. A batch that ``accum`` does not divide,
    or whose microbatch the ranks of a group do not divide, raises
    ``ValueError``."""
    accum = max(1, int(accum))
    if global_batch % accum:
        raise ValueError(f"batch size {global_batch} not divisible by accum_steps={accum}")
    micro = global_batch // accum
    if micro % world == 0:
        return "a"
    if accum % world == 0:
        return "b"
    q = world // math.gcd(world, accum)
    if micro % q:
        raise ValueError(
            f"{world} data-parallel ranks in groups of {q} do not divide the microbatch of {micro} samples "
            f"(a batch of {global_batch} in {accum} microbatches; pad it to a multiple of "
            f"{world * accum // math.gcd(world, accum)})")
    return "c"


def group_size(accum: int, world: int) -> int:
    """q: the data ranks that share each microbatch in layout (c), the
    ``world`` ranks in layout (a), 1 in layout (b); ``world`` / gcd(world,
    ``accum``) in every layout that fits."""
    return world // math.gcd(world, max(1, int(accum)))


def local_rows(global_batch: int, accum: int, world: int, rank: int) -> List[int]:
    """The rows of a padded global batch that ``rank`` trains, in the order
    its step runs them: its microbatches one after another, of each its
    part (all of it in layout (b))."""
    if world == 1:
        return list(range(global_batch))
    accum = max(1, int(accum))
    micro = global_batch // accum
    layout = microbatch_layout(global_batch, accum, world)
    q = world if layout == "a" else group_size(accum, world)
    part, pos = micro // q, rank % q
    return [j * micro + pos * part + k for j in owned_microbatches(accum, world, rank, layout)
            for k in range(part)]


def owned_microbatches(accum: int, world: int, rank: int, layout: str = "b") -> range:
    """The global microbatch indices ``rank`` runs (a part of each in
    layouts (a) and (c)): every one in (a); in (b) and (c) the contiguous
    block of its group, group ``rank // q`` of gcd(world, ``accum``)."""
    accum = max(1, int(accum))
    if layout == "a":
        return range(accum)
    groups = math.gcd(world, accum)
    per, group = accum // groups, rank // (world // groups)
    return range(group * per, (group + 1) * per)


def batch_sharding(mesh: Mesh, global_batch: int, accum: int = 1, rank: Optional[int] = None) -> List[int]:
    """The rows of a padded global batch of ``global_batch`` rows that this
    rank (default: this process) trains on ``mesh``'s data axis."""
    rank = multihost.process_index() if rank is None else rank
    d, _, _ = multihost.mesh_coordinates(rank, mesh.data, mesh.spatial, mesh.model)
    return local_rows(global_batch, accum, mesh.data, d)


def d_slabs(depth: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``parts`` D-slabs of a volume ``depth`` deep:
    whole voxel pairs dealt out as evenly as they go (the first slabs one
    pair longer), the last slab keeping an odd trailing voxel. Raises when
    a slab would be empty."""
    pairs = depth // 2
    if parts < 1 or pairs < parts:
        raise ValueError(f"D={depth} cannot be split into {parts} slabs of whole voxel pairs")
    base, extra = divmod(pairs, parts)
    bounds, start = [], 0
    for r in range(parts):
        stop = start + 2 * (base + (r < extra))
        bounds.append((start, stop))
        start = stop
    bounds[-1] = (bounds[-1][0], depth)
    return bounds


@dataclass(frozen=True)
class LevelPlan:
    """Where the D axis of each U-Net level lies over the ranks of a spatial
    group: ``depths[l]``, the level's whole D, and ``slabs[l]``, each rank's
    [start, stop) there, or None where the level runs replicated (the whole
    D on every rank)."""

    depths: Tuple[int, ...]
    slabs: Tuple[Optional[Tuple[Tuple[int, int], ...]], ...]

    def sharded(self, level: int) -> bool:
        return self.slabs[level] is not None


def level_plan(depth: int, parts: int) -> LevelPlan:
    """The D-slabs of every level for an input ``depth`` deep over ``parts``
    ranks (module docstring): level 0 by :func:`d_slabs`; level l + 1
    sharded, with level l's bounds halved (the last stop the level's own
    D), while every slab of level l starts at an even index and none of
    level l + 1 is empty."""
    depths = [depth]
    for _ in range(LEVELS - 1):
        depths.append(depths[-1] // 2)
    slabs: List[Optional[Tuple[Tuple[int, int], ...]]] = [tuple(d_slabs(depth, parts))]
    for level in range(1, LEVELS):
        above = slabs[-1]
        below = None
        if above is not None and all(start % 2 == 0 for start, _ in above):
            halved = [(start // 2, stop // 2) for start, stop in above[:-1]] + [(above[-1][0] // 2, depths[level])]
            if all(stop > start for start, stop in halved):
                below = tuple(halved)
        slabs.append(below)
    return LevelPlan(tuple(depths), tuple(slabs))


def cut_d_slab(batch: dict, mesh: Mesh, rank: Optional[int] = None) -> dict:
    """A batch of whole rows → this rank's D-slab of them on a spatial
    mesh (``mesh.spatial`` > 1): every array or tensor of 5 dims (the image
    and the label: N, D, H, W, C) is sliced along D, and ``D_SLAB`` records
    (start, stop, depth). On a mesh without a spatial axis, the batch."""
    if mesh.spatial == 1:
        return batch
    rank = multihost.process_index() if rank is None else rank
    _, s, _ = multihost.mesh_coordinates(rank, mesh.data, mesh.spatial, mesh.model)
    depths = {v.shape[1] for v in batch.values() if getattr(v, "ndim", 0) == 5}
    if len(depths) != 1:
        raise ValueError(f"batch entries disagree on the D axis: {sorted(depths)}")
    depth = depths.pop()
    start, stop = d_slabs(depth, mesh.spatial)[s]
    out = {k: v[:, start:stop] if getattr(v, "ndim", 0) == 5 else v for k, v in batch.items()}
    out[D_SLAB] = (start, stop, depth)
    return out


def shard_batch(batch: Any, mesh: Mesh, rank: Optional[int] = None, accum: int = 1) -> Any:
    """This rank's rows (:func:`batch_sharding`) of a global batch dict:
    arrays, tensors and lists with a leading batch axis are sliced, other
    values pass through; on a spatial mesh then its D-slab of them
    (:func:`cut_d_slab`). Arrays and tensors are cut by slicing and
    reshaping, with no index tensor (nothing waits for a copy to the card)."""
    sizes = {len(v) for v in batch.values() if isinstance(v, list) or getattr(v, "ndim", 0) >= 1}
    if len(sizes) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {sorted(sizes)}")
    n, world, accum = sizes.pop(), mesh.data, max(1, int(accum))
    rank = multihost.process_index() if rank is None else rank
    d, _, _ = multihost.mesh_coordinates(rank, mesh.data, mesh.spatial, mesh.model)
    rows = local_rows(n, accum, world, d)

    def take(v):
        if isinstance(v, list):
            return [v[i] for i in rows]
        if getattr(v, "ndim", 0) < 1 or world == 1:
            return v
        if microbatch_layout(n, accum, world) == "a":
            part = n // accum // world
            return v.reshape(accum, world, part, *v.shape[1:])[:, d].reshape(accum * part, *v.shape[1:])
        share = n // world
        return v[d * share: (d + 1) * share]

    return cut_d_slab({k: take(v) for k, v in batch.items()}, mesh, rank)


def param_spec(shape, tp: int) -> tuple:
    """JAX's tensor-parallel spec of a leaf of ``shape`` in the JAX layout
    (``pcmseg_tpu/parallel/sharding.py:81-92``), as a tuple: the trailing
    (output-channel) axis on 'model' where ``tp`` > 1 divides it, e.g.
    ``(None, None, None, None, 'model')`` for a (kD, kH, kW, I, O) kernel;
    ``()`` (replicated) for a scalar or an indivisible leaf. Apply it to a
    JAX-layout shape only: :func:`shard_axis` maps the port's leaves."""
    shape = tuple(shape)
    if tp <= 1 or not shape or shape[-1] % tp:
        return ()
    return (None,) * (len(shape) - 1) + (MODEL_AXIS,)


def shard_axis(module: torch.nn.Module, name: str, shape, tp: int) -> Optional[int]:
    """The axis of ``module``'s leaf ``name`` (of torch ``shape``) that
    :func:`param_spec` shards at ``tp``, or None where it is replicated. The
    JAX layout of each port leaf:

      * ``Conv3x3.weight`` (Co, Ci, 3, 3, 3) ↔ (3, 3, 3, Ci, Co): axis 0;
      * ``ConvTranspose2x.weight`` (Ci, Co, 2, 2, 2) ↔ (2, 2, 2, Ci, Co): axis 1;
      * ``Conv1x1.weight`` (K, C, 1, 1, 1) ↔ (1, 1, 1, C, K): axis 0;
      * biases, norm weights and biases, BatchNorm running statistics (C,):
        axis 0; the scalar ``num_batches_tracked``: replicated."""
    from pcmseg_tpu_torch.models.unet3d import Conv1x1, Conv3x3, ConvTranspose2x

    shape = tuple(shape)
    if name == "weight" and isinstance(module, ConvTranspose2x):
        jax_shape, axis = (*shape[2:], shape[0], shape[1]), 1
    elif name == "weight" and isinstance(module, (Conv3x3, Conv1x1)):
        jax_shape, axis = (*shape[2:], shape[1], shape[0]), 0
    elif len(shape) <= 1:
        jax_shape, axis = shape, 0
    else:
        raise ValueError(f"no JAX layout known for {type(module).__name__}.{name} of shape {shape}")
    return axis if param_spec(jax_shape, tp) else None


def shard_axes(model: torch.nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """:func:`shard_axis` of every state-dict entry of ``model`` (whole, as
    built), by its state-dict key."""
    axes = {}
    for prefix, module in model.named_modules():
        for name, t in list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False)):
            axes[f"{prefix}.{name}" if prefix else name] = shard_axis(module, name, t.shape, tp)
    return axes


def _slice(t: torch.Tensor, axis: Optional[int], rank: int, tp: int) -> torch.Tensor:
    if axis is None:
        return t
    per = t.shape[axis] // tp
    return t.narrow(axis, rank * per, per).clone()


def shard_model(model: torch.nn.Module, comm) -> Dict[str, Optional[int]]:
    """Cut ``model`` (whole, the same on every rank) to this rank's shards
    over the model group ``comm`` (a ``collectives.Comm``), in place: every
    parameter and buffer that :func:`shard_axes` shards keeps its block
    ``comm.rank`` of ``comm.size``, the parameter objects staying the same
    (an optimizer made before still holds them); the norms count their
    local channels; each conv, transposed conv, head and norm gets its
    ``collectives.ChannelShard``. Returns the axes. A 3³ conv off the CPU
    (on a card, or on ``meta`` to check a configuration) whose shard would
    hold a channel count the CUDA kernels cannot take (not a multiple of 8)
    raises ``ValueError`` naming it."""
    from pcmseg_tpu_torch.models.unet3d import BatchNorm, Conv1x1, Conv3x3, ConvTranspose2x, GroupNorm
    from pcmseg_tpu_torch.parallel.collectives import ChannelShard

    tp, rank = comm.size, comm.rank
    axes = shard_axes(model, tp)
    for prefix, module in model.named_modules():
        if isinstance(module, (Conv3x3, Conv1x1)):
            channels = module.weight.shape[0]
        elif isinstance(module, ConvTranspose2x):
            channels = module.weight.shape[1]
        elif isinstance(module, (BatchNorm, GroupNorm)):
            channels = module.num_features if isinstance(module, BatchNorm) else module.num_channels
        else:
            continue
        leaves = list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False))
        shard = ChannelShard(comm, channels, axes[f"{prefix}.weight"] is not None)
        if (shard.sharded and isinstance(module, Conv3x3) and module.weight.device.type != "cpu"
                and (channels // tp) % 8):
            raise ValueError(f"tensor_parallel={tp}: {prefix} would hold {channels // tp} of its {channels} output "
                             "channels, and the CUDA conv kernels take multiples of 8 only")
        with torch.no_grad():
            for n, t in leaves:
                t.data = _slice(t.data, axes[f"{prefix}.{n}"], rank, tp)
        module.tp = shard
        if shard.sharded and isinstance(module, BatchNorm):
            module.num_features = channels // tp
        elif shard.sharded and isinstance(module, GroupNorm):
            module.shard_groups(channels // tp)
    return axes


def local_payload(payload: dict, axes: Dict[str, Optional[int]], names: List[str], rank: int, tp: int) -> dict:
    """A training checkpoint's payload (``train.checkpoints.train_payload``
    of a whole state) → this rank's shards of it: the model's state dict by
    ``axes``, each optimizer state tensor of parameter ``names[i]`` of that
    parameter's shape as the parameter, the EMA by name."""
    out = dict(payload)
    out["model"] = {k: _slice(v, axes[k], rank, tp) for k, v in payload["model"].items()}
    out["optimizer"] = _map_optimizer(payload["optimizer"], names, axes, lambda t, axis: _slice(t, axis, rank, tp))
    if payload.get("ema"):
        out["ema"] = {k: _slice(v, axes[k], rank, tp) for k, v in payload["ema"].items()}
    return out


def whole_payload(payload: dict, axes: Dict[str, Optional[int]], names: List[str], comm) -> dict:
    """The inverse of :func:`local_payload` on every rank of the model group
    ``comm``: each shard all-gathered over it and joined in rank order (a
    collective: every rank of the group calls it, in the same order)."""
    def join(t, axis):
        return t if axis is None else torch.cat(comm.all_gather(t), axis)

    out = dict(payload)
    out["model"] = type(payload["model"])((k, join(v, axes[k])) for k, v in payload["model"].items())
    if hasattr(payload["model"], "_metadata"):
        out["model"]._metadata = payload["model"]._metadata
    out["optimizer"] = _map_optimizer(payload["optimizer"], names, axes, join)
    if payload.get("ema"):
        out["ema"] = {k: join(v, axes[k]) for k, v in payload["ema"].items()}
    return out


def _map_optimizer(opt: dict, names: List[str], axes: Dict[str, Optional[int]], fn) -> dict:
    """An optimizer state dict with ``fn(tensor, axis)`` applied to every
    per-parameter tensor of a parameter's rank (Adam's moments; its scalar
    step count has no axis)."""
    state = {}
    for i, entry in opt["state"].items():
        axis = axes[names[int(i)]]
        state[i] = {k: fn(v, axis if isinstance(v, torch.Tensor) and v.dim() >= 1 else None)
                    for k, v in entry.items()}
    return {**opt, "state": state}


def state_checksum(tensors) -> torch.Tensor:
    """(2,) float64: the sum of every element of ``tensors``, and the same
    sum weighted by each element's position (so that a swap shows)."""
    total = torch.zeros(2, dtype=torch.float64)
    for t in tensors:
        flat = t.detach().reshape(-1).double()
        pos = torch.arange(1, flat.numel() + 1, dtype=torch.float64, device=flat.device) / flat.numel()
        total += torch.stack([flat.sum(), (flat * pos).sum()]).cpu()
    return total


def _same_on(comm, mine: torch.Tensor, what: str) -> None:
    """Raise unless ``mine`` (a checksum) is the same on every rank of ``comm``."""
    import torch.distributed as dist

    device = multihost.local_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    lo, hi = mine.to(device), mine.to(device)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=comm.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=comm.group)
    if not (torch.equal(lo.cpu(), mine) and torch.equal(hi.cpu(), mine)):
        raise RuntimeError(
            f"rank {multihost.process_index()}: {what} differs across ranks "
            f"(checksums from {lo.tolist()} to {hi.tolist()})"
        )


def shard_state(model: torch.nn.Module, mesh: Mesh) -> Optional[Dict[str, Optional[int]]]:
    """Place the model on the mesh. Every rank builds it whole from the same
    seed; on a mesh with a model axis each rank then keeps its shards
    (:func:`shard_model`, over its model group) and the axes are returned
    (None without a model axis). Checksums show that the copies match: the
    replicated leaves across every rank, each shard across the ranks that
    hold it (the replica group); a rank whose copy differs raises. The
    optimizer state and the EMA are made after this, from the shards."""
    import torch.distributed as dist

    from pcmseg_tpu_torch.parallel import collectives

    if mesh.model > 1 and not dist.is_initialized():
        raise ValueError(f"a model axis of {mesh.model} needs a process group of {mesh.size} ranks")
    if not dist.is_initialized():
        return None
    comms = collectives.mesh_comms(mesh)
    axes = shard_model(model, comms.model) if mesh.model > 1 else None
    leaves = model.state_dict()
    replicated = [t for k, t in leaves.items() if axes is None or axes[k] is None]
    _same_on(comms.world, state_checksum(replicated), "the replicated state")
    if axes is not None:
        shards = [t for k, t in leaves.items() if axes[k] is not None]
        _same_on(comms.replica, state_checksum(shards), "a shard of the state")
    return axes
