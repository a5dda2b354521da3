"""Multi-process runs on ``torch.distributed``, the port of
``pcmseg_tpu/parallel/multihost.py``: one process per card, on one host or
several.

  * :func:`initialize` starts the process group once per process: with no
    arguments from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), the counterpart of
    JAX's pod auto-detection; or from an explicit coordinator address,
    process count and process id, as the CPU test clusters start it.
  * :func:`process_local_indices`: a process's strided share of a case list,
    computed alike on every process with no traffic.
  * :func:`barrier` meets every process over the group's key-value store
    (a ``TCPStore``), never through a device collective, as JAX's meets
    over its coordination service. A thread of its own may call it while
    the training thread is inside a gloo or NCCL collective: the
    asynchronous checkpoint writer does.
  * :func:`establish_collectives` runs one all-reduce while the processes
    are aligned, so a backend's communicator is made before the first real
    step.
  * :func:`mesh_coordinates` and :func:`mesh_groups`: a rank's place on a
    (data, spatial, model) mesh, in the order of JAX's ``make_mesh``
    (``pcmseg_tpu/parallel/sharding.py:61-64``), and the process groups of
    the ranks that share one coordinate.

Without a process group every function gives the single-process answer.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


class _Coordinator:
    """Where the job's store listens, and one client of it per thread for
    the barriers (a store client serves one request at a time)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._local = threading.local()

    def store(self):
        client = getattr(self._local, "store", None)
        if client is None:
            client = dist.TCPStore(self.host, self.port, is_master=False, timeout=TIMEOUT)
            self._local.store = client
        return client


_coordinator: Optional[_Coordinator] = None


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count()) if torch.cuda.is_available() else 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the job's process group (a no-op when this process already has one).

    With no arguments the topology comes from torchrun's environment; else
    ``coordinator_address`` is ``host:port`` (``tcp://`` optional), where
    process 0 opens the store. ``backend`` defaults to ``nccl`` where CUDA
    is available and ``gloo`` elsewhere; ``gloo`` on CUDA tensors is the
    caller's explicit choice (two ranks sharing one card: NCCL refuses
    that). An NCCL group selects the card ``LOCAL_RANK`` first (by default
    the process id modulo the host's card count). A failed init raises:
    no backend stands in for another."""
    global _coordinator
    if dist.is_initialized():
        return
    store = None
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "initialize() without arguments reads torchrun's environment, and "
                + ", ".join(missing) + " is not set: run under torchrun or pass the coordinator address, "
                "the process count and the process id"
            )
        host, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        address = coordinator_address.split("://", 1)[-1]
        host, _, port_s = address.rpartition(":")
        host, port = host or "localhost", int(port_s)
        world, rank = int(num_processes), int(process_id)
        store = dist.TCPStore(host, port, world, is_master=rank == 0, timeout=TIMEOUT)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(
        backend,
        init_method=None if store is not None else "env://",
        store=store,
        world_size=world,
        rank=rank,
        timeout=TIMEOUT,
    )
    _coordinator = _Coordinator(host, port)


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _coordinator
    if dist.is_initialized():
        dist.destroy_process_group()
    _coordinator = None
    _groups.clear()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


process_index = _rank  # this process's rank (0 without a group)
process_count = _world  # the processes in the job (1 without a group)


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and artifacts."""
    return process_index() == 0


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` under torchrun."""
    return torch.device("cuda", _local_rank(process_index()))


def process_local_indices(
    indices: Sequence[int],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """Process ``i``'s strided share ``indices[i::P]`` of a case list. Every
    process calls it with the same list, so the shares partition it with
    no traffic; strided, so a sorted list does not give one process all its
    large or early cases (``multihost.py:73-88``)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return list(indices)[pi::pc]


def _store():
    if _coordinator is not None:
        return _coordinator.store()
    # a group that the caller made with init_process_group itself: its own store client
    return dist.distributed_c10d._get_default_store()


_tags: dict = {}


def next_tag(prefix: str) -> str:
    """``prefix`` made unique in this process by a count of its uses: the
    same on every process that makes the same calls in the same order, as
    barrier tags need."""
    n = _tags[prefix] = _tags.get(prefix, -1) + 1
    return f"{prefix}#{n}"


def barrier(tag: str, timeout: datetime.timedelta = TIMEOUT, error: Optional[str] = None) -> None:
    """Wait until every process has reached ``barrier(tag)``, over the store
    (no device collective, safe from any thread). ``tag`` is unique per call
    across the job and the same on every process. A process that failed at
    what the barrier waits for still arrives, with ``error`` saying what
    failed: every other process then raises ``RuntimeError`` with it when
    the barrier opens, instead of waiting out ``timeout``. No-op without a
    process group."""
    if not dist.is_initialized():
        return
    store = _store()
    key = f"pcmseg/barrier/{tag}"
    if error is not None:
        store.set(key + "/error", f"process {process_index()}: {error}")
    if store.add(key, 1) == process_count():
        store.set(key + "/open", "1")
    store.wait([key + "/open"], timeout)
    if error is None and store.check([key + "/error"]):
        raise RuntimeError(f"barrier {tag!r}: {store.get(key + '/error').decode()}")


def establish_collectives(tag: str = "pcmseg_warmup") -> None:
    """One all-reduce over every process while they are aligned, checked,
    then a barrier: the backend's communicator (gloo's context, NCCL's
    clique) is made here and not at the first step. No-op without a
    process group."""
    if not dist.is_initialized():
        return
    device = local_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if float(x) != process_count():
        raise RuntimeError(f"all-reduce of ones over {process_count()} processes gave {float(x)}")
    barrier(tag)


def mesh_coordinates(rank: int, data: int, spatial: int, model: int = 1) -> tuple:
    """(d, s, m) of ``rank`` on a data × spatial × model mesh: the ranks in
    the order JAX reshapes its devices, ``rank = (d·spatial + s)·model + m``."""
    if not 0 <= rank < data * spatial * model:
        raise ValueError(f"rank {rank} outside a {data}x{spatial}x{model} mesh")
    return rank // (spatial * model), (rank // model) % spatial, rank % model


_groups: dict = {}


def mesh_groups(data: int, spatial: int, model: int = 1, microbatch: int = 1) -> dict:
    """This rank's process groups on a data × spatial × model mesh over the
    whole job, each as ``(group, ranks)`` with the group as ``dist.new_group``
    made it (None: the whole job):

      * 'spatial': the ranks that hold the other D-slabs of the same rows
        and the same channels;
      * 'data': those that hold the same D-slab of other rows and the same
        channels;
      * 'model': those that hold the other channel shards of the same
        D-slab of the same rows;
      * 'replica': every rank that holds the same channels (the data ×
        spatial ranks of one model coordinate), over which the gradients
        are summed;
      * with ``microbatch`` = q, 1 < q < ``data`` (layout (c),
        ``sharding.microbatch_layout``), 'microbatch': the q data ranks of
        this rank's group (data coordinate // q) times the spatial ranks,
        with one model coordinate, the ranks that hold the parts of the
        same microbatches; and 'microbatch_rows': those of them that hold
        this rank's D-slab.

    Every rank makes every group, in one order (spatial groups by (d, m),
    data groups by (s, m), model groups by (d, s), replica groups by m,
    microbatch groups by (group, m), their rows by (group, s, m)), as
    ``new_group`` asks; made once per mesh shape and process group, the
    microbatch groups once per q."""
    if data * spatial * model != process_count():
        raise ValueError(f"a {data}x{spatial}x{model} mesh over {process_count()} processes")
    if microbatch > 1 and (data % microbatch or microbatch == data):
        raise ValueError(f"microbatch groups of {microbatch} of {data} data ranks")

    def rank(d, s, m):
        return (d * spatial + s) * model + m

    d, s, m = mesh_coordinates(process_index(), data, spatial, model)
    key = (data, spatial, model)
    if key not in _groups:
        every = {
            "spatial": [[rank(d, s, m) for s in range(spatial)] for d in range(data) for m in range(model)],
            "data": [[rank(d, s, m) for d in range(data)] for s in range(spatial) for m in range(model)],
            "model": [[rank(d, s, m) for m in range(model)] for d in range(data) for s in range(spatial)],
            "replica": [[rank(d, s, m) for d in range(data) for s in range(spatial)] for m in range(model)],
        }
        pick = {"spatial": d * model + m, "data": s * model + m, "model": d * spatial + s, "replica": m}
        _groups[key] = _make_groups(every, pick)
    if microbatch <= 1:
        return _groups[key]
    if key + (microbatch,) not in _groups:
        q, groups = microbatch, data // microbatch
        every = {
            "microbatch": [[rank(j * q + i, s, m) for i in range(q) for s in range(spatial)]
                           for j in range(groups) for m in range(model)],
            "microbatch_rows": [[rank(j * q + i, s, m) for i in range(q)]
                                for j in range(groups) for s in range(spatial) for m in range(model)],
        }
        j = d // q
        pick = {"microbatch": j * model + m, "microbatch_rows": (j * spatial + s) * model + m}
        _groups[key + (microbatch,)] = dict(_groups[key], **_make_groups(every, pick))
    return _groups[key + (microbatch,)]


def _make_groups(every: dict, pick: dict) -> dict:
    """Every group of every axis made, in order; this rank's of each."""
    mine = {}
    for axis, lists in every.items():
        made = [None if len(r) == process_count() else dist.new_group(r) for r in lists]
        mine[axis] = (made[pick[axis]], lists[pick[axis]])
    return mine
