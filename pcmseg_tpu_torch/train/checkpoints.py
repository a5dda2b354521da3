"""Reference-layout ``.pth`` checkpoints, the JAX-parameter bridge, and the
trainer's checkpoints.

The port's state dict is the reference PyTorch model's (module names in
``models/unet3d.py``), so the ``.pth`` files that
``pcmseg_tpu.train.checkpoints.export_torch_checkpoint`` writes load here
unchanged: ``{'model_state_dict': ..., 'config': {...}}``, or a bare state
dict.

Weight layouts:
  * JAX conv kernel (kD, kH, kW, I, O) ↔ ``.pth`` conv weight (O, I, kD, kH, kW);
  * JAX transposed-conv kernel (kD, kH, kW, I, O), stored spatially flipped
    (``pcmseg_tpu/train/checkpoints.py:335-339``) ↔ ``.pth`` (I, O, kD, kH, kW);
  * BN scale/bias/mean/var ↔ weight/bias/running_mean/running_var;
    GroupNorm scale/bias ↔ weight/bias (no running statistics);
  * a K-class head's ``outc`` (and ``ds{i}``) has K outputs.
The conv kernel's own packed layout is built from the ``.pth`` layout at
run time (``ops/kernels/conv3d.py::pack_weight``).
"""

from __future__ import annotations

import copy
import os
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


_DS_HEAD = re.compile(r"ds\d+\.")


def _tensor(a) -> torch.Tensor:
    """A copy of the numpy array ``a`` in its own dtype. A bfloat16 array
    (ml_dtypes' type, recognised by name: this package does not import it),
    which ``torch.from_numpy`` does not take, goes through its uint16 bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _conv_weight(kernel) -> torch.Tensor:
    # (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)
    return _tensor(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _conv_transpose_weight(kernel) -> torch.Tensor:
    # undo the JAX side's spatial flip, then (kD, kH, kW, I, O) -> (I, O, kD, kH, kW)
    a = np.asarray(kernel)[::-1, ::-1, ::-1]
    return _tensor(np.transpose(a, (3, 4, 0, 1, 2)))


# The one map between the JAX package's parameter tree and the port's names.
# A double conv's layers: the port's index in its Sequential, the JAX module.
_DOUBLE_CONV = {"0": "conv0", "1": "norm0", "3": "conv1", "4": "norm1"}
# Each double conv: its path in the JAX tree, the port's module prefix.
_DOUBLE_CONVS = (
    (("inc",), "inc.conv"),
    *(((f"down{i}", "double_conv"), f"down{i}.maxpool_conv.1.conv") for i in range(1, 5)),
    *(((f"up{i}", "double_conv"), f"up{i}.conv.conv") for i in range(1, 5)),
)
_JAX_PATH = {prefix: path for path, prefix in _DOUBLE_CONVS}
# leaf names: a conv's and a norm's, the port's to JAX's
_CONV_LEAF = {"weight": "kernel", "bias": "bias"}
_NORM_LEAF = {"weight": "scale", "bias": "bias"}


def jax_leaf_path(name: str) -> tuple:
    """The path in the JAX package's parameter tree of the port's parameter
    ``name`` (the map :func:`state_dict_from_jax_params` reads forwards):
    sorted, the paths give ``jax.tree.leaves``' order. Every other module
    (``up{i}.up``, ``outc``, ``ds{i}``) has the same path on both sides."""
    module, leaf = name.rsplit(".", 1)
    prefix, _, idx = module.rpartition(".")
    if prefix in _JAX_PATH:
        layer = _DOUBLE_CONV[idx]
        return (*_JAX_PATH[prefix], layer, (_CONV_LEAF if layer.startswith("conv") else _NORM_LEAF)[leaf])
    return (*module.split("."), _CONV_LEAF[leaf])


def state_dict_from_jax_params(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's params as numpy trees.

    Mirrors ``pcmseg_tpu.train.checkpoints.params_to_torch_state_dict``
    without importing JAX. Each tensor keeps its leaf's dtype (fp32, bf16 or
    fp16 parameters; fp32 batch statistics). BN-folded trees (no ``norm{i}`` entries) give a
    state dict for ``UNet3D(norm_layer='none')``; GroupNorm trees (``norm{i}``
    without batch statistics) one for ``UNet3D(norm_layer='group')``. A deep-supervision tree's
    aux heads ``ds{i}``, which that exporter leaves out, become ``ds{i}.weight``
    and ``ds{i}.bias`` of ``UNet3D(deep_supervision=True)``.
    """
    batch_stats = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}

    def at(tree: Mapping, path: tuple) -> Optional[Mapping]:
        for key in path:
            tree = (tree or {}).get(key)
        return tree

    for path, prefix in _DOUBLE_CONVS:
        ours, stats = at(params, path), at(batch_stats, path)
        for idx, layer in _DOUBLE_CONV.items():
            if layer not in ours:  # a BN-folded tree's norms
                continue
            conv = layer.startswith("conv")
            leaves = ours[layer]
            sd[f"{prefix}.{idx}.weight"] = _conv_weight(leaves["kernel"]) if conv else _tensor(leaves["scale"])
            sd[f"{prefix}.{idx}.bias"] = _tensor(leaves["bias"])
            if not conv and stats and layer in stats:
                sd[f"{prefix}.{idx}.running_mean"] = _tensor(stats[layer]["mean"])
                sd[f"{prefix}.{idx}.running_var"] = _tensor(stats[layer]["var"])
                sd[f"{prefix}.{idx}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    for i in range(1, 5):
        up = params[f"up{i}"]["up"]
        sd[f"up{i}.up.weight"] = _conv_transpose_weight(up["kernel"])
        sd[f"up{i}.up.bias"] = _tensor(up["bias"])
    for name in ["outc"] + [f"ds{i}" for i in range(1, 4) if f"ds{i}" in params]:
        sd[f"{name}.weight"] = _conv_weight(params[name]["kernel"])
        sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    return sd


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """(state dict, config snapshot or None) from a reference-layout .pth.

    Loads with ``weights_only=True``: tensors and plain containers only.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint dict")
    if "model_state_dict" in payload:
        return dict(payload["model_state_dict"]), payload.get("config") or None
    return dict(payload), None


def save_pth(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config: Optional[dict] = None,
    meta: Optional[dict] = None,
) -> str:
    """Write ``{'model_state_dict': ..., 'config': ...}`` atomically; the
    ``meta`` entries go beside them, as ``export_torch_checkpoint`` writes
    its meta."""
    payload = {"model_state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    payload.update(meta or {})
    if config:
        payload["config"] = config
    return _atomic_write(path, lambda tmp: torch.save(payload, tmp))


def _atomic_write(path: str, write) -> str:
    """``write(tmp)`` to a temporary name beside ``path``, then ``os.replace``
    it into place, so an interrupted write leaves the previous file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path), f".tmp-{os.getpid()}-{os.path.basename(path)}")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


# ---- training checkpoints ----------------------------------------------------
#
# The Orbax half of ``pcmseg_tpu/train/checkpoints.py``: one file per name
# (``latest``, ``best``, ``epoch_{e}``) holding the model state dict (BN
# running statistics included), the optimizer state, the EMA, the step count
# and the trainer's meta (epoch, history, best monitor, scheduler and early
# stopping), written with ``torch.save`` to a temporary name and moved into
# place with ``os.replace``, so an interrupted save leaves the previous file.

TRAIN_SUFFIX = ".pt"


def train_checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(directory)), name + TRAIN_SUFFIX)


def train_payload(state) -> dict:
    """What a training checkpoint holds of ``state`` (a
    ``train.steps.TrainState``): the model and optimizer state dicts, the
    EMA and the step, as the live tensors."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
        "step": state.step,
    }


def write_train_checkpoint(directory: str, name: str, payload: dict, meta: Optional[dict] = None) -> str:
    """Write ``payload`` (``train_payload`` of a state, or a ``Snapshot``'s)
    and ``meta`` under ``{directory}/{name}.pt``; returns the path."""
    payload = {**payload, "meta": meta or {}}
    return _atomic_write(train_checkpoint_path(directory, name), lambda tmp: torch.save(payload, tmp))


def save_train_checkpoint(directory: str, name: str, state, meta: Optional[dict] = None) -> str:
    """Write ``state`` and ``meta`` under ``{directory}/{name}.pt``; returns the path."""
    return write_train_checkpoint(directory, name, train_payload(state), meta)


def copy_train_checkpoint(directory: str, src: str, dst: str) -> str:
    """Duplicate checkpoint ``src`` as ``dst`` (a file copy, atomically
    moved into place), without serializing the state again."""
    src_path = train_checkpoint_path(directory, src)
    return _atomic_write(train_checkpoint_path(directory, dst), lambda tmp: shutil.copyfile(src_path, tmp))


def load_train_checkpoint(path: str, state, local: Optional[Callable[[dict], dict]] = None) -> dict:
    """Restore ``state`` in place from a ``save_train_checkpoint`` file (onto
    the devices its tensors already live on); returns the meta dict. A
    checkpoint without an EMA restarts the EMA from the restored params.
    ``local`` maps the file's payload to the part of it that ``state``
    holds first (a tensor-parallel rank's shards: ``sharding.local_payload``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if local is not None:
        payload = local(payload)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.ema is not None:
        ema = payload.get("ema") or {k: p.detach() for k, p in state.model.named_parameters()}
        for k, v in state.ema.items():
            v.copy_(ema[k])
    return dict(payload.get("meta") or {})


def serving_state_dict(
    model_state: Mapping[str, torch.Tensor],
    ema: Optional[Mapping[str, torch.Tensor]],
    use_ema: bool = True,
) -> Dict[str, torch.Tensor]:
    """The weights that validation scores and serving serves, in the
    reference layout: the model's state dict, with the EMA of the
    parameters in place of the live ones when there is one and ``use_ema``,
    without the training-only deep-supervision heads (``ds{i}.*``)."""
    sd = dict(model_state)
    if use_ema and ema:
        sd.update(ema)
    return {k: v for k, v in sd.items() if not _DS_HEAD.match(k)}


def export_train_checkpoint(path: str, output: str, use_ema: bool = True) -> str:
    """Training checkpoint ``path`` (a ``.pt`` file) → reference-layout
    ``.pth`` at ``output``, with the meta keys the JAX package's export
    carries (``exported_from``, ``epoch``, ``monitor``, ``best_monitor``,
    ``config``)."""
    if not path.endswith(TRAIN_SUFFIX) or not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path!r}: expected a training checkpoint file ({{save_dir}}/{{name}}{TRAIN_SUFFIX})"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = payload.get("meta") or {}
    extra = {"exported_from": os.path.abspath(path)}
    extra.update({k: meta[k] for k in ("epoch", "monitor", "best_monitor") if k in meta})
    weights = serving_state_dict(payload["model"], payload.get("ema"), use_ema)
    return save_pth(output, weights, meta.get("config"), extra)


def prune_periodic(directory: str, keep: int, tag: str = "") -> None:
    """Delete all but the newest ``keep`` ``epoch_{e}`` checkpoints, or
    ``epoch_{e}_{tag}`` ones under a tag (0 keeps all)."""
    if keep <= 0:
        return
    directory = os.path.abspath(os.path.expanduser(directory))
    suffix = f"_{tag}{TRAIN_SUFFIX}" if tag else TRAIN_SUFFIX
    found = []
    for entry in os.listdir(directory):
        epoch = entry[len("epoch_"): -len(suffix)] if entry.endswith(suffix) else ""
        if entry.startswith("epoch_") and epoch.isdigit():
            found.append((int(epoch), entry))
    for _, entry in sorted(found)[:-keep]:
        os.remove(os.path.join(directory, entry))


# ---- asynchronous checkpoints --------------------------------------------------
#
# The port's state is mutated in place by the next step (JAX's is immutable,
# so its writer can hold the submitted state as it is): a thread that saved
# the live tensors while the next epoch trains would write a file that mixes
# two epochs. The writer therefore saves a ``Snapshot``: the payload copied
# into host buffers owned by the snapshot, on a side stream (D2H into pinned
# memory on CUDA), and the training stream waits for that copy before its
# next kernel (the next forward updates the BN running statistics in place,
# the next optimizer step the parameters and moments). The buffers of at
# most ``max_sets`` snapshots exist and are reused epoch after epoch.


def _leaves(tree, out: list) -> list:
    """The tensors of a nested dict/list/tuple payload, in traversal order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _rebuild(tree, tensors):
    """``tree`` with its tensors taken in order from the iterator ``tensors``
    and everything else copied; a state dict keeps its type and its
    ``_metadata`` (module versions), as ``torch.save`` of the live one does."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        out = type(tree)((k, _rebuild(v, tensors)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = copy.deepcopy(tree._metadata)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, tensors) for v in tree)
    return copy.deepcopy(tree)


@dataclass
class Snapshot:
    """A training state's checkpoint payload in host buffers. ``ready`` is
    the CUDA event of its D2H copy (None when nothing was on a card)."""

    payload: dict
    buffers: List[torch.Tensor]
    layout: tuple
    ready: Optional["torch.cuda.Event"] = None

    def wait(self) -> None:
        """Block until the copy has landed in the host buffers."""
        if self.ready is not None:
            self.ready.synchronize()


class SnapshotPool:
    """Host buffers for snapshots of one trainer's state on ``device``, at
    most ``max_sets`` sets, each reused once its snapshot is released.

    A tensor on a CUDA device is copied into pinned memory on a side stream
    that first waits for the training stream; the training stream then
    waits on the copy's event, so its next kernel cannot change a tensor
    before it is copied. The host is not blocked. CPU tensors (Adam's step
    counts; every tensor of a CPU run) are copied at once.
    """

    def __init__(self, device, max_sets: int = 2):
        self.device = torch.device(device)
        self.max_sets = max_sets
        self._free: List[Tuple[tuple, List[torch.Tensor]]] = []
        self._n_sets = 0
        self._lock = threading.Lock()
        self._stream = None
        self.pinned_bytes = 0  # pinned bytes of the sets that exist
        self.peak_pinned_bytes = 0

    @staticmethod
    def _pinned(layout: tuple, buffers: List[torch.Tensor]) -> int:
        return sum(b.numel() * b.element_size() for b, (_, _, kind) in zip(buffers, layout) if kind == "cuda")

    def _acquire(self, layout: tuple) -> List[torch.Tensor]:
        with self._lock:
            for i, (lay, buffers) in enumerate(self._free):
                if lay == layout:
                    return self._free.pop(i)[1]
            if self._n_sets >= self.max_sets:
                raise RuntimeError(f"more than {self.max_sets} snapshots outstanding")
            self._n_sets += 1
        buffers = [
            torch.empty(shape, dtype=dtype, pin_memory=kind == "cuda") for shape, dtype, kind in layout
        ]
        with self._lock:
            self.pinned_bytes += self._pinned(layout, buffers)
            self.peak_pinned_bytes = max(self.peak_pinned_bytes, self.pinned_bytes)
        return buffers

    def take(self, state, payload: Optional[dict] = None) -> Snapshot:
        """Snapshot of ``payload``, by default ``state``'s ``train_payload``."""
        payload = train_payload(state) if payload is None else payload
        leaves = _leaves(payload, [])
        layout = tuple((tuple(t.shape), t.dtype, t.device.type) for t in leaves)
        buffers = self._acquire(layout)
        ready = None
        if any(t.is_cuda for t in leaves):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                for b, t in zip(buffers, leaves):
                    b.copy_(t.detach(), non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
            main.wait_event(ready)
        else:
            for b, t in zip(buffers, leaves):
                b.copy_(t.detach())
        return Snapshot(_rebuild(payload, iter(buffers)), buffers, layout, ready)

    def release(self, snapshot: Snapshot) -> None:
        """Return a snapshot's buffers for reuse (its payload is void after)."""
        with self._lock:
            self._free.append((snapshot.layout, snapshot.buffers))

    def clear(self) -> None:
        """Drop the free buffer sets."""
        with self._lock:
            for layout, buffers in self._free:
                self._n_sets -= 1
                self.pinned_bytes -= self._pinned(layout, buffers)
            self._free.clear()


class AsyncCheckpointWriter:
    """One writer thread for a trainer's checkpoints
    (``pcmseg_tpu/train/trainer.py:357-455, 854-868``).

    ``submit(kind, state, write)`` snapshots ``state`` (or the ``payload``
    given for it, made on the caller's thread) and queues ``write(payload)``
    on the thread:

      * latest-wins collapse: a queued, not yet started task of the same
        ``kind`` is cancelled ('latest' onto 'latest', 'best' (best +
        latest) onto 'best'); 'periodic' tasks never collapse, and nothing
        does with ``collapse=False`` (data-parallel processes: whether a
        task is still queued depends on each process's timing, and every
        process must run the same sequence of writes and barriers);
      * backpressure: at most ``max_outstanding`` snapshots are in flight;
        the caller waits for the oldest beyond that;
      * a writer failure is raised by the next ``submit``/``drain`` and by
        ``drain(wait=True)``; ``close()`` completes queued writes and never
        cancels them.

    ``stats``: tasks submitted, tasks collapsed, seconds the caller was
    blocked (backpressure and draining included), and each task's writer
    seconds; ``snapshots.peak_pinned_bytes`` the pinned memory held.
    """

    def __init__(self, device, max_outstanding: int = 2, collapse: bool = True):
        self.max_outstanding = max_outstanding
        self.collapse = collapse
        self.snapshots = SnapshotPool(device, max_outstanding)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._tasks: List[Tuple[str, Future, Snapshot]] = []
        self.stats = {"submitted": 0, "collapsed": 0, "blocked_s": 0.0, "task_s": []}

    def _run(self, snapshot: Snapshot, write: Callable[[dict], Any]) -> None:
        t0 = time.perf_counter()
        try:
            snapshot.wait()
            write(snapshot.payload)
        finally:
            self.snapshots.release(snapshot)
            self.stats["task_s"].append(time.perf_counter() - t0)

    def in_flight(self) -> int:
        """Tasks queued or running."""
        return sum(not f.done() for _, f, _ in self._tasks)

    def submit(self, kind: str, state, write: Callable[[dict], Any], payload: Optional[dict] = None) -> None:
        t0 = time.perf_counter()
        if kind != "periodic" and self.collapse:
            kept = []
            for k, f, snap in self._tasks:
                if k == kind and f.cancel():
                    self.snapshots.release(snap)
                    self.stats["collapsed"] += 1
                    continue
                kept.append((k, f, snap))
            self._tasks = kept
        while True:
            live = [f for _, f, _ in self._tasks if not f.done()]
            if len(live) < self.max_outstanding:
                break
            live[0].result()  # the oldest; re-raises a writer failure
        self.drain()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pcmseg_ckpt")
        snapshot = self.snapshots.take(state, payload)
        self._tasks.append((kind, self._pool.submit(self._run, snapshot, write), snapshot))
        self.stats["submitted"] += 1
        self.stats["blocked_s"] += time.perf_counter() - t0

    def drain(self, wait: bool = False) -> None:
        """Raise the first writer failure among finished tasks and forget
        them; with ``wait``, block until every task has finished first."""
        t0 = time.perf_counter()
        still, error = [], None
        for k, f, snap in self._tasks:
            if f.cancelled():
                continue
            if wait or f.done():
                if error is None:
                    error = f.exception()
                else:
                    f.exception()
            else:
                still.append((k, f, snap))
        self._tasks = still
        if wait:
            self.stats["blocked_s"] += time.perf_counter() - t0
        if error is not None:
            raise error

    def close(self) -> None:
        """Complete the queued writes, stop the thread and drop the buffers
        (idempotent; the writer starts again at the next ``submit``)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        for _, f, _ in self._tasks:
            if not f.cancelled():
                f.exception()  # consumed: a failure was raised by drain, or the caller is failing already
        self._tasks.clear()
        self.snapshots.clear()
