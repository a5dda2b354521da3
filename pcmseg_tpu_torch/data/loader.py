"""Batch iteration with background decode and pinned-memory device prefetch.

The port of ``pcmseg_tpu/data/loader.py`` (``:27-235``, ``:284-310``):
``DataLoader`` with the same ``(seed + epoch)`` shuffle, ``_padded_plan``
padding (ragged tail batches cycle real samples and mark them weight 0),
the bounded window of threaded decodes and ``set_epoch`` for resume. The
host ``Augmenter`` is the port's copy of the JAX package's (``data/augment.py``),
called per (epoch, index) as there, its float32 output rounded back to
bf16 values. ``prefetch_to_device`` replaces
``background_prefetch`` and ``jax.device_put``: one producer thread,
pinned host memory and ``non_blocking`` copies on a side stream, ``size``
batches ahead. ``RamCaseCache`` is the host-RAM memo of the partial device
cache's streamed remainder (``loader.py:54-86``). There is no
``drop_last``. ``process_shard=(index, count)`` makes a loader of one
data-parallel process: it decodes and yields only that process's rows of
every padded global batch (``loader.py:104-108, :190-195``), the rows
``parallel.sharding.local_rows`` gives, so the weights of a ragged tail
stay aligned across the processes however unevenly its real samples fall.
On a data × spatial mesh ``index`` and ``count`` are the process's data
coordinate and the data ranks: the processes of one spatial group load
the same rows, and each keeps its D-slab of them
(``parallel.sharding.cut_d_slab``, the trainer's host side).
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu_torch.data.dataset import bf16_bits, bf16_round, from_bf16_bits
from pcmseg_tpu_torch.parallel.sharding import local_rows


def _padded_plan(idxs: List[int], pad_to: Optional[int]) -> Tuple[List[int], List[float]]:
    """(dataset indices, per-sample weights) for one batch, padding included."""
    n = len(idxs)
    total = pad_to if pad_to is not None and pad_to > n else n
    picked = [idxs[i % n] for i in range(total)]
    return picked, [1.0] * n + [0.0] * (total - n)


def _collate(samples: List[dict], weights: List[float]) -> dict:
    return {
        "image": np.stack([s["image"] for s in samples]),
        "label": np.stack([s["label"] for s in samples]),
        "case_id": [s["case_id"] for s in samples],
        "weight": np.asarray(weights, np.float32),
    }


class RamCaseCache:
    """Dataset view that keeps ``load_case`` results of a fixed index set in
    host RAM: the partial device cache's streamed remainder, re-read every
    epoch, then costs no per-epoch ``.npz`` decode.

    A case is kept as its bf16 bits (uint16) and uint8 label, the JAX
    package's wire bytes (~23 MB per 128³ 5-modality case), and every read
    returns fresh arrays: the float32 wire image and a copy of the label.
    So a transform that writes into the arrays it was handed (the host
    blur branch does, for float32 images) never reaches the memo, where the
    JAX package's memo hands out its own arrays (``loader.py:73``).
    Everything else delegates to the base dataset."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self._keep = {int(i) for i in indices}
        self._memo: dict = {}

    def load_case(self, i: int) -> dict:
        got = self._memo.get(i)
        if got is None:
            sample = self.base.load_case(i)
            if i not in self._keep:
                return sample
            got = (bf16_bits(sample["image"]), sample["label"], sample["case_id"])
            self._memo[i] = got
        bits, label, case_id = got
        return {"image": from_bf16_bits(bits), "label": label.copy(), "case_id": case_id}

    def __len__(self) -> int:
        return len(self.base)

    def __getattr__(self, name):
        return getattr(self.base, name)


class DataLoader:
    """Iterates padded batches of a ``ProstateDataset`` (optionally
    index-restricted), decoding ``num_workers`` cases at a time ahead of the
    consumer. Arguments as the JAX package's ``DataLoader``; with
    ``process_shard=(index, count)``, only that process's rows of each
    padded global batch, which ``count`` must divide, and with
    ``accum_steps`` > 1 the rows of its microbatches in the layout of
    ``parallel.sharding`` (a contiguous slice with ``accum_steps=1``, as
    JAX's ``process_shard`` takes)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 2,
        shuffle: bool = True,
        indices: Optional[Sequence[int]] = None,
        num_workers: int = 4,
        pad_to: Optional[int] = None,
        seed: int = 0,
        augmenter=None,
        process_shard: Optional[Tuple[int, int]] = None,
        accum_steps: int = 1,
    ):
        self.dataset = dataset
        self.augmenter = augmenter
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        for i in self.indices:
            if not 0 <= i < len(dataset):
                raise IndexError(
                    f"subset index {i} out of range for dataset of {len(dataset)} cases"
                )
        self.num_workers = max(1, int(num_workers))
        self.pad_to = pad_to
        self.seed = seed
        self.process_shard = tuple(process_shard) if process_shard else None
        self.accum_steps = max(1, int(accum_steps))
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def plan(self, batch: List[int]) -> Tuple[List[int], List[float]]:
        """(dataset indices, weights) of this process's rows of one batch,
        padding included."""
        picked, weights = _padded_plan(batch, self.pad_to)
        if self.process_shard is None:
            return picked, weights
        index, count = self.process_shard
        if len(picked) % count:
            raise ValueError(
                f"padded batch size {len(picked)} not divisible by process_count={count}; "
                "set pad_to to a multiple"
            )
        rows = local_rows(len(picked), self.accum_steps, count, index)
        return [picked[r] for r in rows], [weights[r] for r in rows]

    def set_epoch(self, epoch: int) -> None:
        """Align the epoch counter that seeds the shuffle and augmentation,
        so a resumed run replays the order an uninterrupted run would use."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[dict]:
        order = list(self.indices)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        epoch = self._epoch
        self._epoch += 1

        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]

        def load_one(i: int) -> dict:
            sample = self.dataset.load_case(i)
            if self.augmenter is not None:
                sample = self.augmenter(sample, epoch, i)
                # back onto the bf16 wire: the augmenter keeps float32 here
                sample["image"] = bf16_round(sample["image"])
            return sample

        def realize(b: List[int]) -> dict:
            picked, weights = self.plan(b)
            memo: dict = {}  # a padded tail repeats indices: decode each once
            samples = []
            for i in picked:
                if i not in memo:
                    memo[i] = load_one(i)
                samples.append(memo[i])
            out = _collate(samples, weights)
            if self.process_shard is not None:
                out["n_real"] = float(len(b))  # the global batch's real samples
            return out

        if self.num_workers <= 1:
            for b in batches:
                yield realize(b)
            return
        window = self.num_workers + 1
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = deque(pool.submit(realize, b) for b in itertools.islice(batches, window))
            rest = iter(batches[window:])
            while pending:
                f = pending.popleft()
                nxt = next(rest, None)
                if nxt is not None:
                    pending.append(pool.submit(realize, nxt))
                yield f.result()


def to_device(batch: dict, device, image_dtype: torch.dtype) -> Dict[str, object]:
    """One host batch → tensors on ``device``: the image in ``image_dtype``
    (exact for the bf16-valued wire), labels and weights as they are. On
    CUDA through pinned memory with ``non_blocking`` copies on the current
    stream; the caller orders the consumer after them."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        host = torch.from_numpy(np.ascontiguousarray(v))
        if k == "image":
            host = host.to(image_dtype)
        if device.type == "cuda":
            out[k] = host.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = host
    return out


def prefetch_to_device(iterator, device, image_dtype: torch.dtype, size: int = 2):
    """Move host batches to ``device`` ahead of consumption, ``size`` deep;
    returns the iterator of moved batches.

    A producer thread, started by this call, runs ``iterator`` (the
    loader's decodes) and casts and copies each batch; on CUDA it pins it
    and copies on a side stream, recording an event that the consumer's
    stream waits on before using the batch, so decode and copies overlap
    compute, also compute that runs before the first batch is taken (the
    partial cache's steps ahead of its first streamed one)."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    err: list = []

    def producer():
        try:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                for batch in iterator:
                    moved = to_device(batch, device, image_dtype)
                    done = None
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                    q.put((moved, done))
        except Exception as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    def consumer():
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            moved, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for v in moved.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)  # allocated on the side stream, used here
            yield moved

    threading.Thread(target=producer, daemon=True).start()
    return consumer()
