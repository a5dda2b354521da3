"""The ('data', 'spatial', 'model') mesh over the ranks and the rows of a
global batch each rank trains: the port of
``pcmseg_tpu/parallel/sharding.py:35-128`` as far as data parallelism
needs it.

One rank is one process on one card. ``data`` ranks train disjoint rows of
each global batch with replicated parameters; BatchNorm and the loss sum
over the global batch (``collectives``), as GSPMD made them in JAX, and
the gradients are summed by one all-reduce a step. ``spatial`` and
``model`` (tensor) parallelism are not ported: a config with either above 1
is refused by name where a trainer or step is built
(``train/steps.py::refuse_unported_training``).

A padded global batch of B rows, run as A microbatches of m = B / A rows
(JAX's ``lax.scan`` over ``reshape(A, m, ...)``), is spread over P ranks
in one of two layouts (:func:`microbatch_layout`):

  (a) P divides m: every rank holds m / P rows of every microbatch, and
      BatchNorm and the loss are synchronised inside each microbatch;
  (b) P divides A: every rank runs A / P whole microbatches, the
      contiguous block ``rank·A/P .. (rank+1)·A/P − 1``, with no collective
      inside a microbatch.

:func:`local_rows` gives a rank's rows in the order its step runs them, so
a loader or a gather hands each rank exactly those rows. With A = 1 it is
the contiguous slice ``rank·B/P .. (rank+1)·B/P − 1``, JAX's
``process_shard``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from pcmseg_tpu_torch.parallel import multihost

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"


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
    """'a' or 'b' (module docstring) for a padded global batch of
    ``global_batch`` rows in ``accum`` microbatches over ``world`` ranks;
    'a' when both fit. Anything else raises ``NotImplementedError`` naming
    the numbers."""
    accum = max(1, int(accum))
    if global_batch % accum:
        raise ValueError(f"batch size {global_batch} not divisible by accum_steps={accum}")
    micro = global_batch // accum
    if micro % world == 0:
        return "a"
    if accum % world == 0:
        return "b"
    raise NotImplementedError(
        f"{world} data-parallel ranks divide neither the microbatch of {micro} samples nor "
        f"accum_steps={accum} (a batch of {global_batch} in {accum} microbatches)"
    )


def local_rows(global_batch: int, accum: int, world: int, rank: int) -> List[int]:
    """The rows of a padded global batch that ``rank`` trains, in the order
    its step runs them: its microbatches one after another."""
    if world == 1:
        return list(range(global_batch))
    accum = max(1, int(accum))
    micro = global_batch // accum
    if microbatch_layout(global_batch, accum, world) == "a":
        part = micro // world
        return [j * micro + rank * part + k for j in range(accum) for k in range(part)]
    share = global_batch // world
    return list(range(rank * share, (rank + 1) * share))


def owned_microbatches(accum: int, world: int, rank: int) -> range:
    """Layout (b): the global microbatch indices ``rank`` runs."""
    per = max(1, int(accum)) // world
    return range(rank * per, (rank + 1) * per)


def batch_sharding(mesh: Mesh, global_batch: int, accum: int = 1, rank: Optional[int] = None) -> List[int]:
    """The rows of a padded global batch of ``global_batch`` rows that this
    rank (default: this process) trains on ``mesh``'s data axis."""
    rank = multihost.process_index() if rank is None else rank
    return local_rows(global_batch, accum, mesh.data, rank % mesh.data)


def shard_batch(batch: Any, mesh: Mesh, rank: Optional[int] = None, accum: int = 1) -> Any:
    """This rank's rows (:func:`batch_sharding`) of a global batch dict:
    arrays, tensors and lists with a leading batch axis are sliced, other
    values pass through. Arrays and tensors are cut by slicing and
    reshaping, with no index tensor (nothing waits for a copy to the card)."""
    sizes = {len(v) for v in batch.values() if isinstance(v, list) or getattr(v, "ndim", 0) >= 1}
    if len(sizes) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {sorted(sizes)}")
    n, world, accum = sizes.pop(), mesh.data, max(1, int(accum))
    rank = (multihost.process_index() if rank is None else rank) % world
    rows = local_rows(n, accum, world, rank)

    def take(v):
        if isinstance(v, list):
            return [v[i] for i in rows]
        if getattr(v, "ndim", 0) < 1 or world == 1:
            return v
        if microbatch_layout(n, accum, world) == "a":
            part = n // accum // world
            return v.reshape(accum, world, part, *v.shape[1:])[:, rank].reshape(accum * part, *v.shape[1:])
        share = n // world
        return v[rank * share: (rank + 1) * share]

    return {k: take(v) for k, v in batch.items()}


def param_spec(shape, tp: int) -> tuple:
    """Every parameter is replicated: the spec of a replicated leaf, ``()``.
    Tensor parallelism (``tp`` > 1: output-channel shards of the convs) is
    not ported and raises."""
    if tp > 1:
        raise NotImplementedError(f"not ported to the PyTorch package yet: tensor_parallel={tp}")
    return ()


def state_checksum(model: torch.nn.Module) -> torch.Tensor:
    """(2,) float64: the sum of every parameter and buffer element, and the
    same sum weighted by each element's position (so that a swap shows)."""
    total = torch.zeros(2, dtype=torch.float64)
    for t in list(model.parameters()) + list(model.buffers()):
        flat = t.detach().reshape(-1).double()
        pos = torch.arange(1, flat.numel() + 1, dtype=torch.float64, device=flat.device) / flat.numel()
        total += torch.stack([flat.sum(), (flat * pos).sum()]).cpu()
    return total


def shard_state(model: torch.nn.Module, mesh: Mesh) -> None:
    """Place the state on the mesh: replicated on every rank. Each rank
    builds it from the same seed; one all-reduce of its checksum shows that
    the copies match, and a rank whose copy differs raises."""
    import torch.distributed as dist

    for p in model.parameters():
        param_spec(tuple(p.shape), mesh.model)
    if not dist.is_initialized():
        return

    mine = state_checksum(model)
    device = multihost.local_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    lo, hi = mine.to(device), mine.to(device)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not (torch.equal(lo.cpu(), mine) and torch.equal(hi.cpu(), mine)):
        raise RuntimeError(
            f"rank {multihost.process_index()}: the replicated state differs across ranks "
            f"(checksums from {lo.tolist()} to {hi.tolist()})"
        )
