"""The collectives of data, spatial and tensor parallelism. In JAX, GSPMD
inserted them where a reduction ran over an axis sharded on the mesh,
where a 3³ conv read across a D-slab's edge, and where a layer read the
channels that other ranks' shards of its producer computed; here they are
written out.

  * :class:`Comm`: a group of ranks that sum and gather together.
    :class:`ProcessComm` is a ``torch.distributed`` group (one process a
    rank); :class:`LocalGroup` hands out the members of a group of threads
    in one process (a Predictor's shards, one thread a shard), whose
    collectives are device-to-device copies met at a barrier.
  * :func:`synchronized_batch` marks the code in which a reduction over the
    batch means over the global batch: over the ranks that hold parts of it
    (``batch``: the voxels) or over those that hold its other rows
    (``rows``: per-sample values already summed over the D-slabs). The loss
    and the eval metrics sum through :func:`batch_sum` and :func:`row_sum`,
    BatchNorm all-reduces its sums (``models/unet3d.py``, :func:`norm_scope`).
    Outside it every reduction over the batch is this rank's own.
  * :func:`spatial` marks the code in which this rank holds one D-slab of
    its rows (:class:`SpatialPlan`): the model's convs exchange halos
    (:func:`halo_exchange`), its deep levels may be gathered whole
    (:func:`gather_d`), and per-sample sums go over the slabs
    (:func:`spatial_sum`).
  * :func:`all_reduce_sum` is differentiable: its backward all-reduces the
    cotangent too. Every rank computes the same (replicated) loss from the
    summed statistics, so a rank seeds its backward with 1/size of the
    batch group (:func:`backward_scale`), and the summed parameter
    gradients are then the global loss's.
  * :class:`ChannelShard` marks a layer of a tensor-parallel model (the
    'model' axis): its output channels in contiguous shards over the model
    group, the whole input gathered from the shards before it reads it
    (:func:`gather_channels`), its input gradient summed over the group
    (:func:`sum_input_grads`).
  * :class:`GradientAllReduce`: the gradients of every parameter (this
    rank's shards of the sharded ones), copied into one flat fp32 buffer in
    parameter order, summed by one collective a step over the ranks that
    hold the same channels, and copied back (16-bit parameters on a mesh
    whose microbatches span ranks: their fp32 gradients, one collective a
    microbatch, ``train/steps.py``). A fixed order keeps the step
    deterministic and the result bitwise equal on every rank.
  * :func:`exchange`: the sum of contributions that are zero on all ranks
    but one element by element (rows written by their owner into a zeroed
    buffer), made exact by summing the bytes: every byte is added to
    zeros, so it arrives unchanged, whatever the dtype (gloo refuses int16
    and sums floats in their own arithmetic, where −0 + 0 is +0).

The collectives of a process group run whenever this process is in one
(:func:`active`), a group of one rank included: there they are identities
that still go through the backend (the chip check runs a one-rank NCCL
group so). Without a group every reduction is this process's own.

The states of :func:`synchronized_batch` and of :func:`spatial` are
process-wide, not per thread: CUDA runs the backward (and a
rematerialised block's forward within it) on autograd's own threads. A
serving shard's thread sets its plan for itself (``spatial(...,
this_thread=True)``), which wins over the process-wide one there.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pcmseg_tpu_torch.parallel import multihost
from pcmseg_tpu_torch.parallel.sharding import LevelPlan, Mesh
from pcmseg_tpu_torch.utils.profiling import span


def active() -> bool:
    """Whether this process is in a process group, and collectives run."""
    return dist.is_initialized()


# ---- groups --------------------------------------------------------------------


class Comm:
    """A group of ``size`` ranks, this one ``rank`` among them, that sum
    (:meth:`all_reduce`) and gather (:meth:`all_gather`) together."""

    size: int
    rank: int

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, in place, summed over the group; bitwise equal on every rank."""
        raise NotImplementedError

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape and dtype on all), in rank order,
        on ``t``'s device: new tensors, bit for bit."""
        raise NotImplementedError


class ProcessComm(Comm):
    """The ranks ``ranks`` of the job's process group, as ``group`` (None:
    the whole job) holds them. Gathers move bytes (any dtype, exact), on a
    CUDA tensor under gloo staged through host memory."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group, self.ranks = group, tuple(ranks)
        self.size, self.rank = len(self.ranks), self.ranks.index(dist.get_rank())

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        t = t.contiguous()
        stage = t.is_cuda and dist.get_backend(self.group) == "gloo"
        raw = (t.cpu() if stage else t).view(-1).view(torch.uint8)
        out = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(out, raw, group=self.group)
        return [o.to(t.device).view(t.dtype).view(t.shape) for o in out]


class LocalGroup:
    """``size`` threads of one process that act as the ranks of a group, one
    a shard (:meth:`member`). A collective posts each member's tensor, meets
    at a barrier, copies the posted tensors to each member's device, and
    meets again before a slot is reused. A member that fails calls
    :meth:`abort`, and every member waiting at the barrier raises
    ``threading.BrokenBarrierError`` instead of waiting out ``timeout``."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: List[Optional[torch.Tensor]] = [None] * size

    def member(self, rank: int) -> "LocalComm":
        return LocalComm(self, rank)

    def abort(self) -> None:
        self._barrier.abort()


class LocalComm(Comm):
    def __init__(self, group: LocalGroup, rank: int):
        self.group, self.size, self.rank = group, group.size, rank

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        # a copy on this member's device (for another card, through PyTorch's
        # peer copy, which orders itself after both devices' current streams)
        out = [s.to(t.device, copy=True) for s in g._slots]
        g._barrier.wait()
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        parts = self.all_gather(t)
        total = parts[0]
        for p in parts[1:]:
            total += p  # in rank order on every member: the same bits on all
        return t.copy_(total)


_world: List[Optional[ProcessComm]] = [None]


def world_comm() -> ProcessComm:
    """Every rank of the job's process group."""
    comm = _world[0]
    if comm is None or comm.size != multihost.process_count() or comm.rank != multihost.process_index():
        comm = _world[0] = ProcessComm(None, range(multihost.process_count()))
    return comm


@dataclass(frozen=True)
class MeshComms:
    """This rank's groups on a data × spatial × model mesh: ``world``;
    ``data``, the ranks that hold the same D-slab and channels of other
    rows; ``spatial``, the ranks that hold the other D-slabs of the same
    rows and channels; ``model``, the ranks that hold the other channel
    shards of the same D-slab of the same rows; ``replica``, every rank
    that holds the same channels (``multihost.mesh_groups``)."""

    world: Comm
    data: Comm
    spatial: Comm
    model: Comm
    replica: Comm


def mesh_comms(mesh: Mesh) -> MeshComms:
    """The groups of ``mesh`` over the job's process group (made on every
    rank in the same order: ``multihost.mesh_groups``)."""
    groups = multihost.mesh_groups(mesh.data, mesh.spatial, mesh.model)
    return MeshComms(world_comm(), *(ProcessComm(*groups[axis]) for axis in ("data", "spatial", "model", "replica")))


def microbatch_comms(mesh: Mesh, q: int) -> Tuple[Comm, Comm]:
    """Layout (c) with q data ranks a microbatch: (the ranks that hold the
    parts of this rank's microbatches, those of them that hold its D-slab)
    (``multihost.mesh_groups``' 'microbatch' and 'microbatch_rows')."""
    groups = multihost.mesh_groups(mesh.data, mesh.spatial, mesh.model, microbatch=q)
    return ProcessComm(*groups["microbatch"]), ProcessComm(*groups["microbatch_rows"])


# ---- batch-wide sums -------------------------------------------------------------


@dataclass(frozen=True)
class _Sync:
    batch: Comm
    rows: Optional[Comm]


_sync: List[Optional[_Sync]] = [None]


@contextlib.contextmanager
def synchronized_batch(enabled: bool = True, batch: Optional[Comm] = None, rows: Optional[Comm] = None):
    """Reductions over the batch inside are global (in a process group,
    when ``enabled``): over the voxels of the ranks ``batch``, and over the
    samples of the ranks ``rows`` (None: this rank holds every row of the
    batch). Without ``batch``, both are the whole job."""
    prev = _sync[0]
    _sync[0] = None
    if enabled and active():
        if batch is None:
            batch = rows = world_comm()
        _sync[0] = _Sync(batch, rows)
    try:
        yield
    finally:
        _sync[0] = prev


def batch_synchronized() -> bool:
    return _sync[0] is not None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.clone()), None


def all_reduce_sum(x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
    """The sum of ``x`` over ``comm`` (default: every rank), differentiable
    (module docstring)."""
    return _AllReduceSum.apply(x, comm or world_comm())


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's voxels of a batch, summed over every
    rank's part inside :func:`synchronized_batch`; ``x`` itself outside."""
    sync = _sync[0]
    return all_reduce_sum(x, sync.batch) if sync is not None else x


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's rows of per-sample values that are
    whole (summed over the D-slabs), summed over the ranks of the other
    rows inside :func:`synchronized_batch`; ``x`` itself outside."""
    sync = _sync[0]
    return all_reduce_sum(x, sync.rows) if sync is not None and sync.rows is not None else x


def backward_scale() -> float:
    """What a rank seeds the backward of a replicated loss with: 1/size of
    the batch group inside :func:`synchronized_batch`, else 1."""
    sync = _sync[0]
    return 1.0 / sync.batch.size if sync is not None else 1.0


def norm_scope(level: int, voxels: int, depth: int) -> Tuple[Optional[Comm], int]:
    """(the ranks whose sums a synchronised BatchNorm at U-Net ``level``
    adds to its own, or None for none; the voxels of the whole sum) for a
    tensor of ``voxels`` voxels, ``depth`` of them along D. The group: the
    batch group (the whole job without :func:`synchronized_batch`); on a
    spatially sharded rank, at a level that runs replicated, the ranks of
    the other rows only, whose statistics are already whole over D."""
    sync = _sync[0]
    batch = sync.batch if sync is not None else world_comm()
    plan = spatial_plan()
    if plan is None:
        return batch, voxels * batch.size
    if plan.sharded(level):
        return batch, voxels // depth * plan.depth(level) * (batch.size // plan.comm.size)
    rows = sync.rows if sync is not None else None
    return rows, voxels * (rows.size if rows is not None else 1)


def exchange(t: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
    """In place and returned: the sum over ``comm`` (default: every rank) of
    ``t``, where each element is non-zero on one rank at most, bitwise
    (summed as bytes)."""
    if not active():
        return t
    if not t.is_contiguous():
        raise ValueError("exchange needs a contiguous tensor")
    (comm or world_comm()).all_reduce(t.view(-1).view(torch.uint8))
    return t


# ---- spatial parallelism: D-slabs ---------------------------------------------------


@dataclass(frozen=True)
class SpatialPlan:
    """This rank's part of a spatially sharded forward: ``comm``, the ranks
    that hold the other D-slabs of the same rows (this rank ``comm.rank``
    among them), and ``levels``, where each U-Net level's D lies
    (``sharding.level_plan``)."""

    comm: Comm
    levels: LevelPlan

    def sharded(self, level: int) -> bool:
        return self.levels.sharded(level)

    def depth(self, level: int) -> int:
        return self.levels.depths[level]

    def slab(self, level: int) -> Tuple[int, int]:
        """This rank's [start, stop) at ``level``; the whole D where the level
        runs replicated."""
        slabs = self.levels.slabs[level]
        return slabs[self.comm.rank] if slabs is not None else (0, self.depth(level))


_plan: List[Optional[SpatialPlan]] = [None]
_thread = threading.local()


@contextlib.contextmanager
def spatial(plan: Optional[SpatialPlan], this_thread: bool = False):
    """Inside, this rank holds the D-slab of ``plan`` (None: the whole
    volume); process-wide, or for this thread only with ``this_thread``."""
    holder = _thread if this_thread else None
    prev = getattr(_thread, "plan", None) if holder is not None else _plan[0]
    if holder is not None:
        _thread.plan = plan
    else:
        _plan[0] = plan
    try:
        yield
    finally:
        if holder is not None:
            _thread.plan = prev
        else:
            _plan[0] = prev


def spatial_plan() -> Optional[SpatialPlan]:
    """The plan in force: this thread's, else the process's, else None."""
    plan = getattr(_thread, "plan", None)
    return plan if plan is not None else _plan[0]


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a per-sample sum over this rank's D-slab, summed over the
    slabs of the sample (differentiable) where a plan is in force; else
    ``x``."""
    plan = spatial_plan()
    return all_reduce_sum(x, plan.comm) if plan is not None else x


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        ends = comm.all_gather(torch.cat([x[:, :1], x[:, -1:]], 1))
        r, n = comm.rank, comm.size
        zero = torch.zeros_like(x[:, :1])
        lo = ends[r - 1][:, 1:] if r > 0 else zero
        hi = ends[r + 1][:, :1] if r < n - 1 else zero
        return torch.cat([lo, x, hi], 1)

    @staticmethod
    def backward(ctx, dy):
        comm = ctx.comm
        r, n = comm.rank, comm.size
        ends = comm.all_gather(torch.cat([dy[:, :1], dy[:, -1:]], 1))
        dx = dy[:, 1:-1].clone()
        if r > 0:  # the left neighbour's upper halo was my first slice
            dx[:, :1] += ends[r - 1][:, 1:]
        if r < n - 1:  # the right neighbour's lower halo was my last slice
            dx[:, -1:] += ends[r + 1][:, :1]
        return dx, None


def halo_exchange(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """(N, D, H, W, C) slab → (N, D + 2, H, W, C): the neighbours' facing
    D-slices around it, zeros at the volume's ends (SAME padding there).
    Differentiable: the backward sends each halo's cotangent back to the
    slab it came from and adds it to that slice."""
    return _HaloExchange.apply(x, comm)


class _GatherD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, bounds):
        ctx.comm, ctx.bounds = comm, bounds
        longest = max(stop - start for start, stop in bounds)
        if x.shape[1] < longest:  # slabs of unequal length gather at the longest
            x = torch.cat([x, x.new_zeros((x.shape[0], longest - x.shape[1], *x.shape[2:]))], 1)
        parts = comm.all_gather(x)
        return torch.cat([p[:, : stop - start] for p, (start, stop) in zip(parts, bounds)], 1)

    @staticmethod
    def backward(ctx, dy):
        # every rank's cotangent of the whole is its own share: their sum,
        # cut to this rank's slab (a reduce-scatter), summed in fp32 at least
        total = ctx.comm.all_reduce(dy.to(torch.promote_types(dy.dtype, torch.float32), copy=True))
        start, stop = ctx.bounds[ctx.comm.rank]
        return total[:, start:stop].to(dy.dtype).contiguous(), None, None


def gather_d(x: torch.Tensor, plan: SpatialPlan, level: int) -> torch.Tensor:
    """This rank's D-slab at ``level`` → the whole D, on every rank of the
    spatial group (an all-gather). Differentiable: the backward sums the
    ranks' cotangents of the whole and keeps this rank's slab."""
    return _GatherD.apply(x, plan.comm, plan.levels.slabs[level])


# ---- tensor parallelism: output-channel shards ---------------------------------------


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.width = comm, x.shape[-1]
        return torch.cat(comm.all_gather(x), -1)

    @staticmethod
    def backward(ctx, dy):
        # the cotangent of a whole tensor is whole, and the same, on every rank
        # (module docstring of ChannelShard): this rank's slice of it
        start = ctx.comm.rank * ctx.width
        return dy[..., start: start + ctx.width].contiguous(), None


def gather_channels(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """This rank's channel shard (..., C / size) → the whole (..., C) on
    every rank of ``comm``, the shards in rank order (an all-gather).
    Differentiable: the backward keeps this rank's slice of the whole
    tensor's cotangent, which :class:`ChannelShard` keeps whole on every
    rank."""
    return _GatherChannels.apply(x, comm)


class _SumInputGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return ctx.comm.all_reduce(dx.contiguous().clone()), None


def sum_input_grads(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``x`` itself; in the backward its cotangent summed over ``comm``: the
    input of a layer whose output channels are sharded, each rank's
    cotangent of it a partial sum over its own channels. The sum runs in
    the cotangent's own dtype, as GSPMD all-reduces a partial result in
    its dtype: bf16 or fp16 on the card, where two ranks' sum is rounded once
    either way and half the bytes of an fp32 sum cross."""
    return _SumInputGrads.apply(x, comm)


@dataclass(frozen=True)
class ChannelShard:
    """A layer's ``channels`` output channels over the model group ``comm``:
    ``sharded`` where JAX's rule by shape shards its leaves
    (``sharding.shard_axis``), this rank holding the contiguous block
    ``span``; else whole on every rank.

    What keeps the backward right on every mix of sharded and whole layers:
    a tensor that is whole on every rank of the group has a cotangent that
    is whole and bitwise equal on every rank. A sharded layer's input
    gradient is a partial sum over its own output channels, so the layer
    sums it over the group itself (:meth:`input`, :func:`sum_input_grads`);
    a whole layer's is whole already; so the gather of a shard
    (:func:`gather_channels`) only keeps its rank's slice in the backward,
    whatever layers read the gathered tensor."""

    comm: Comm
    channels: int
    sharded: bool

    @property
    def span(self) -> Tuple[int, int]:
        """This rank's [start, stop) of the layer's output channels."""
        if not self.sharded:
            return 0, self.channels
        per = self.channels // self.comm.size
        return self.comm.rank * per, (self.comm.rank + 1) * per

    def whole(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """``x`` with all of its ``channels`` channels: gathered over the
        group where it holds this rank's shard of them."""
        if x.shape[-1] == channels:
            return x
        if x.shape[-1] * self.comm.size != channels:
            raise ValueError(f"a tensor of {x.shape[-1]} channels is no shard of {channels} over {self.comm.size}")
        return gather_channels(x, self.comm)

    def input(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """The layer's input of ``channels`` channels (gathered where ``x``
        is a shard), with its gradient summed over the group where the
        layer's outputs are sharded."""
        x = self.whole(x, channels)
        return sum_input_grads(x, self.comm) if self.sharded else x


# ---- the gradient all-reduce ----------------------------------------------------------


class GradientAllReduce:
    """Sums the gradients of ``params`` over ``comm`` (default: every rank;
    on a tensor-parallel mesh the ranks that hold the same channels) with
    one all-reduce of a flat fp32 buffer, kept between steps: 16-bit
    gradients (``param_dtype``) are summed in fp32 and rounded back once.
    A call may name other tensors of the same sizes (``grads``, e.g. the
    fp32 gradients of 16-bit parameters) and another group."""

    def __init__(self, params: List[torch.nn.Parameter], comm: Optional[Comm] = None):
        self.params = [p for p in params if p.requires_grad]
        self.comm = comm
        self._flat: Optional[torch.Tensor] = None

    def __call__(self, grads: Optional[List[torch.Tensor]] = None, comm: Optional[Comm] = None) -> None:
        if not active():
            return
        with span("train.backward"):
            if grads is None:
                grads = [p.grad for p in self.params]
            if self._flat is None or self._flat.device != grads[0].device:
                n = sum(g.numel() for g in grads)
                self._flat = torch.empty(n, dtype=torch.float32, device=grads[0].device)
            offset = 0
            for g in grads:
                self._flat[offset: offset + g.numel()].copy_(g.reshape(-1))
                offset += g.numel()
            (comm or self.comm or world_comm()).all_reduce(self._flat)
            offset = 0
            for g in grads:
                g.copy_(self._flat[offset: offset + g.numel()].view_as(g))
                offset += g.numel()
