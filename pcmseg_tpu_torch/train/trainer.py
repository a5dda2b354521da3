"""Single-split trainer on one GPU or data-parallel over several, the port
of ``pcmseg_tpu/train/trainer.py``.

The streamed path of the JAX trainer:

  * the split: ``val_fraction`` of the cases, drawn with
    ``default_rng(seed).permutation``, or the caller's ``train_indices`` /
    ``val_indices`` over a shared ``dataset`` (a cross-validation fold;
    ``val_indices`` alone trains on the rest) (``trainer.py:58-106``);
  * every batch, the ragged tail included, padded to the smallest multiple
    of lcm(data-parallel ranks, ``accum_steps``) that holds ``batch_size``
    (``trainer.py:127-136``, where one process holds every virtual device;
    here the spatial and model ranks of a data coordinate load the same
    rows, so the data ranks are the processes that split a batch);
  * ``train_epoch``: batches decoded by the loader's threads, prefetched to
    the card from pinned memory, each step's loss fetched after the next
    step is queued, and a non-finite loss aborts the epoch
    (``trainer.py:565-598, 670-708``);
  * ``validate_epoch``: loss and weighted Dice/IoU (``trainer.py:710-780``);
  * the epoch loop (``trainer.py:792-852``): the schedule sets the LR, early
    stopping on the monitored loss, ``latest`` every epoch, ``best`` on
    improvement (also written as a reference-layout ``best.pth`` that
    ``predict``, ``serve`` and ``validate`` take as it is), ``epoch_{e}``
    every ``save_frequency`` epochs, pruned to ``keep_checkpoints``; under a
    ``tag`` every name becomes ``{name}_{tag}`` (``best_fold_0.pth``);
  * real resume from ``latest`` (``latest_{tag}``; ``trainer.py:480-508``),
    loaders included;
  * the device data cache (``trainer.py:217-340``, ``data/device_cache.py``):
    when the cohort fits ``device_data_cache_gb``, its stacks live on the
    trainer's device and each step gathers, crops and augments its batch
    there (``_train_epoch_cached``, ``trainer.py:600-668``); when only
    ``pad_to`` or more cases fit (and ``device_cache_partial``), the train
    cases and then the val cases that fit are resident and the rest stream,
    their batches spread over the epoch's steps (Bresenham) from a host-RAM
    memo (``RamCaseCache``); otherwise every epoch streams. The trainer logs
    which way it went. With augmentation off a cached epoch equals a
    streamed one: the same plan, the same batch bytes;
  * ``async_checkpoint`` (``trainer.py:357-455``): each epoch's checkpoints
    are written by one writer thread while the next epoch trains, from a
    snapshot of the state in reused pinned host buffers
    (``train/checkpoints.py``: ``AsyncCheckpointWriter``), with latest-wins
    collapse of queued writes, at most two snapshots in flight, writer
    failures raised at the next epoch boundary and at the end of training,
    and ``close()`` on every exit path of ``train()``;
  * ``profile_dir`` (``trainer.py:346-349``): a ``torch.profiler`` trace of
    ``profile_steps`` steps from the second step on, one window, closed at
    the epoch's end if the epoch ends first (``utils/profiling.py``).

Data parallelism (``trainer.py:108-145, :221-291, :515-544``): in a job
of several processes (``parallel.multihost.initialize``, one card each)
the mesh's data axis spans them and must equal the process count; each
process loads only its rows of every padded global batch (the loaders'
``process_shard``) or, from the device cache, holds a block of the cases
and receives its rows of each gathered batch; the step makes BatchNorm,
the loss and the gradients global (``train/steps.py``). Every process
builds the parameters from the seed, and one all-reduce of a checksum at
start shows that they match. Losses, the schedule and early stopping are
then the same on every process; the primary alone logs and writes
checkpoints, and every process meets it at a barrier over the store after
each write (from the writer thread under ``async_checkpoint``, where the
latest-wins collapse is off so that every process writes the same
sequence). vol/s counts the global batch's samples. In one process a
mesh the host cannot hold warns and runs 1×1×1, as JAX's does.

Spatial parallelism (``trainer.py:108-145``): a data × spatial mesh over
the processes (``spatial_parallel`` > 1; rank ``d·spatial + s``). The
processes of one data coordinate ``d`` load the same rows (the loaders'
``process_shard`` is ``(d, data)``, the cache holds block ``d``), and each
keeps its D-slab ``s`` of every batch (``sharding.cut_d_slab``, on the
host before the copy to the card; from the cache after the crop and the
augmentation of the whole rows); the steps run on the mesh
(``train/steps.py``). A card so holds 1/data of the cached stacks, where
JAX's hold 1/(data·spatial), and the cache's budget counts the data ranks
only.

Tensor parallelism (``trainer.py:109-117``, ``shard_state`` at :196 and
:487): ``tensor_parallel`` > 1 adds the mesh's model axis (rank
``(d·spatial + s)·model + m``). The ranks of one model group load the same
rows and keep the same D-slab; each builds the whole model from the seed
and keeps its output-channel shards (``sharding.shard_state``), from which
the optimizer and the EMA are made. Every checkpoint, ``.pth`` and resume
is in the whole reference layout: before each save every rank gathers the
shards over its model group on the training thread, in epoch order (a
collective, never on the writer thread), and a resume cuts the loaded
whole state to this rank's shards again.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pcmseg_tpu_torch.core.config import Config
from pcmseg_tpu_torch.data import device_cache
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.data.loader import DataLoader, RamCaseCache, _padded_plan, prefetch_to_device
from pcmseg_tpu_torch.infer.predict import resolve_device
from pcmseg_tpu_torch.models import build_model
from pcmseg_tpu_torch.models.unet3d import compute_dtype
from pcmseg_tpu_torch.parallel import collectives, multihost
from pcmseg_tpu_torch.parallel.sharding import (
    Mesh,
    cut_d_slab,
    local_payload,
    make_mesh,
    padded_batch_size,
    shard_state,
    whole_payload,
)
from pcmseg_tpu_torch.train.checkpoints import (
    AsyncCheckpointWriter,
    copy_train_checkpoint,
    load_train_checkpoint,
    prune_periodic,
    save_pth,
    serving_state_dict,
    train_checkpoint_path,
    train_payload,
    write_train_checkpoint,
)
from pcmseg_tpu_torch.train.schedule import EarlyStopping, make_scheduler
from pcmseg_tpu_torch.utils.logging import StepTimer, get_logger
from pcmseg_tpu_torch.utils.profiling import StepTraceController
from pcmseg_tpu_torch.train.steps import (
    create_train_state,
    make_eval_step,
    make_train_step,
    set_learning_rate,
)


class Trainer:
    """Config-driven trainer over one train(/val) split on ``device``
    (default: the current CUDA device; without one, pass ``device="cpu"``)."""

    def __init__(
        self,
        config: Config,
        dataset: Optional[ProstateDataset] = None,
        train_indices: Optional[Sequence[int]] = None,
        val_indices: Optional[Sequence[int]] = None,
        tag: str = "",
        device=None,
    ):
        self.config = config
        self.tag = tag
        self.log = get_logger(f"pcmseg.trainer{('.' + tag) if tag else ''}")
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)

        self.dataset = dataset if dataset is not None else ProstateDataset(
            data_dir=config.data_dir,
            data_type=config.data_type,
            modalities=config.modalities,
            missing_strategy=config.missing_strategy,
            target_size=config.target_size,
            normalize=config.normalize,
            norm_percentiles=config.norm_percentiles,
            cache_dir=config.cache_dir,
            n_classes=config.n_classes,
            coregister=config.coregister,
        )
        n = len(self.dataset)
        if n == 0:
            raise RuntimeError(
                f"no valid cases found under {config.data_dir!r} (data_type={config.data_type})"
            )

        # -- split ----------------------------------------------------------
        if train_indices is None and val_indices is not None:
            # val alone: train on the complement
            val_set = {int(i) for i in val_indices}
            train_indices = [i for i in range(n) if i not in val_set]
        elif train_indices is None:
            if config.validation and n >= 2:
                perm = np.random.default_rng(config.seed).permutation(n)
                n_val = max(1, int(round(n * config.val_fraction)))
                val_indices = np.sort(perm[:n_val]).tolist()
                train_indices = np.sort(perm[n_val:]).tolist()
            else:
                train_indices = list(range(n))
                val_indices = None
        self.train_indices: List[int] = list(train_indices)
        self.val_indices: Optional[List[int]] = list(val_indices) if val_indices is not None else None

        # -- mesh (before the loaders: batches pad to a multiple of the ranks) --
        self.process_count = multihost.process_count()
        self.process_index = multihost.process_index()
        self.is_primary = self.process_index == 0
        try:
            self.mesh = make_mesh(config.data_parallel, config.spatial_parallel, config.tensor_parallel)
        except ValueError as e:
            if self.process_count > 1:
                raise
            self.log.warning("mesh config infeasible on this host (%s); using 1x1x1", e)
            self.mesh = Mesh()
        if self.mesh.size != self.process_count:
            raise ValueError(
                f"mesh {self.mesh.data}x{self.mesh.spatial}x{self.mesh.model} over {self.process_count} "
                "processes: a multi-process job runs one process per rank of the mesh"
            )
        if not self.is_primary:
            self.log.setLevel("WARNING")
        # every batch pads to one size, divisible by the data-parallel ranks
        # (the processes that load other rows: the spatial and model ranks
        # of one data coordinate load the same ones) and the accumulation steps
        accum = max(1, int(config.accum_steps))
        self._pad_to = padded_batch_size(config.batch_size, self.mesh.data, self.mesh.data, accum)
        # in a process group (of one rank too) the loaders and the cache
        # shard by this process's data coordinate
        data_index = multihost.mesh_coordinates(self.process_index, *self.mesh.shape.values())[0]
        self._shard = (data_index, self.mesh.data) if collectives.active() else None

        augmenter = None
        if config.data_augmentation or config.train_crop:
            from pcmseg_tpu_torch.data.augment import Augmenter

            aug_on = config.data_augmentation
            augmenter = Augmenter(
                seed=config.seed,
                flip=aug_on and config.aug_flip,
                rot90=aug_on and config.aug_rot90,
                intensity_jitter=config.aug_intensity_jitter if aug_on else 0.0,
                crop=config.train_crop,
                oversample_fg=config.oversample_fg,
                oversample_mode=config.oversample_mode,
                scale=config.aug_scale if aug_on else 0.0,
                rotate_deg=config.aug_rotate_deg if aug_on else 0.0,
                gamma=config.aug_gamma if aug_on else 0.0,
                noise=config.aug_noise if aug_on else 0.0,
                blur_prob=config.aug_blur_prob if aug_on else 0.0,
            )
        self.train_loader = DataLoader(
            self.dataset, batch_size=config.batch_size, shuffle=True,
            indices=self.train_indices, seed=config.seed, augmenter=augmenter,
            pad_to=self._pad_to, process_shard=self._shard, accum_steps=accum,
        )
        self.val_loader = (
            DataLoader(
                self.dataset, batch_size=config.batch_size, shuffle=False,
                indices=self.val_indices, pad_to=self._pad_to, process_shard=self._shard,
            )
            if self.val_indices
            else None
        )

        # -- model / state ----------------------------------------------------
        model = build_model(
            config, deep_supervision=config.deep_supervision,
            generator=torch.Generator().manual_seed(config.seed),
        )
        # the same parameters on every rank, or raise; on a model axis this
        # rank's shards of them (axes: None without one)
        self._axes = shard_state(model.to(self.device), self.mesh)
        self.state = create_train_state(model, config)
        self._train_step = make_train_step(model, config, mesh=self.mesh)
        self._eval_step = make_eval_step(model, config, mesh=self.mesh)
        self._setup_device_cache(augmenter)
        self._epochs_run = 0  # cached epochs: their plan and draws are (seed, epoch) derived

        self.scheduler = make_scheduler(config)
        self.early_stopping = EarlyStopping(patience=config.patience)
        self.history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        self.best_monitor = float("inf")
        self.start_epoch = 0
        self.timer = StepTimer(warmup_steps=1)
        self.tracer = StepTraceController(config.profile_dir, self.device, n_steps=config.profile_steps)
        self.writer = (
            AsyncCheckpointWriter(self.device, collapse=not collectives.active()) if config.async_checkpoint else None
        )
        if config.resume:
            self._try_resume()

    def _setup_device_cache(self, augmenter) -> None:
        """Full cache, partial cache or streaming, by the budget of one card
        times the data-parallel ranks, which split the stacks
        (``trainer.py:225-337``; JAX's stacks split over the spatial ranks
        too, and its budget counts them)."""
        config = self.config
        self._dcache = None
        self._dcache_partial = False
        self._stream_train_loader = self._stream_val_loader = None
        n_cases = len(self.dataset)
        per_case = device_cache.dataset_device_bytes(1, config.target_size, config.n_modalities)
        if config.device_data_cache_gb <= 0:
            self.log.info("device data cache off (device_data_cache_gb=0): every epoch streams from the host")
            return
        shards = self.mesh.data
        n_fit = int(config.device_data_cache_gb * 1e9 * shards // per_case)
        resident = None
        if n_fit >= n_cases:
            resident = list(range(n_cases))
        elif n_fit >= self._pad_to and config.device_cache_partial:
            # train cases first (gathered every epoch), then val
            resident = self.train_indices[:n_fit]
            if len(resident) < n_fit and self.val_indices:
                resident += self.val_indices[: n_fit - len(resident)]
            self._dcache_partial = True
        if resident is None:
            self.log.info(
                "device data cache: %d cases need %.3g GB, above the budget of %.3g GB%s; every epoch "
                "streams from the host", n_cases, n_cases * per_case / 1e9, config.device_data_cache_gb,
                " (partial cache off)" if n_fit >= self._pad_to else f" and {n_fit} fit, fewer than a batch",
            )
            return
        self.log.info(
            "device data cache: %d/%d cases resident on %s (%.3g GB a card over %d shard(s))%s",
            len(resident), n_cases, self.device, len(resident) * per_case / shards / 1e9, shards,
            " - remainder streams (partial cache)" if self._dcache_partial else "",
        )
        self._dcache = device_cache.build_device_cache(
            self.dataset, self.device, indices=resident if self._dcache_partial else None, shard=self._shard,
        )
        held = self._dcache["rows"]
        self._cached_train_step = device_cache.make_cached_train_step(config, self._train_step, held, self.mesh)
        self._cached_eval_step = device_cache.make_cached_eval_step(self._eval_step, held, self.mesh)
        if not self._dcache_partial:
            return
        # case index -> stack row, and the train/val sets split into their
        # resident and streamed parts
        self._dcache_row = {c: r for r, c in enumerate(resident)}
        res = set(resident)
        self._res_train = [i for i in self.train_indices if i in res]
        self._str_train = [i for i in self.train_indices if i not in res]
        self._res_val = [i for i in (self.val_indices or []) if i in res]
        self._str_val = [i for i in (self.val_indices or []) if i not in res]
        # the remainder's cases in host RAM, up to stream_host_cache_gb
        ram_gb = config.stream_host_cache_gb
        n_ram = int(ram_gb * 1e9 // per_case) if ram_gb > 0 else 0
        streamed = self._str_train + self._str_val
        stream_ds = RamCaseCache(self.dataset, streamed[:n_ram]) if n_ram > 0 else self.dataset
        if self._str_train:
            self._stream_train_loader = DataLoader(
                stream_ds, batch_size=config.batch_size, shuffle=True, indices=self._str_train,
                seed=config.seed, augmenter=augmenter, pad_to=self._pad_to, process_shard=self._shard,
                accum_steps=config.accum_steps,
            )
        if self._str_val:
            self._stream_val_loader = DataLoader(
                stream_ds, batch_size=config.batch_size, shuffle=False, indices=self._str_val,
                pad_to=self._pad_to, process_shard=self._shard,
            )

    # -- checkpoints -------------------------------------------------------------

    def _ckpt_name(self, base: str) -> str:
        return f"{base}_{self.tag}" if self.tag else base

    def _meta(self, epoch: int, monitor: float) -> dict:
        return {
            "epoch": epoch,
            "monitor": monitor,
            "best_monitor": self.best_monitor,
            "history": self.history,
            "scheduler": self.scheduler.state_dict(),
            "early_stopping": self.early_stopping.state_dict(),
            "config": self.config.to_dict(),
            "tag": self.tag,
        }

    def _save_epoch(self, epoch: int, monitor: float, is_best: bool) -> None:
        """This epoch's checkpoints, written now or (``async_checkpoint``)
        by the writer thread from a snapshot while the next epoch trains.
        One serialization per epoch: 'best' and 'epoch_{e}' are file copies
        of 'latest', and ``best.pth`` holds the same state's serving weights."""
        cfg = self.config
        meta = self._meta(epoch, monitor)
        if self.writer is not None:
            meta = copy.deepcopy(meta)  # the live history grows under the writer
        latest, best = self._ckpt_name("latest"), self._ckpt_name("best")
        periodic = bool(cfg.save_frequency) and (epoch + 1) % cfg.save_frequency == 0

        # the same on every process: its saves come in the same order
        done_tag = multihost.next_tag(f"ckpt/{self.tag or 'run'}/{epoch}")

        def write(payload: dict) -> None:
            try:
                if self.is_primary:
                    write_train_checkpoint(cfg.save_dir, latest, payload, meta)
                    if is_best:
                        copy_train_checkpoint(cfg.save_dir, latest, best)
                        weights = serving_state_dict(payload["model"], payload["ema"], cfg.ema_eval)
                        save_pth(os.path.join(cfg.save_dir, best + ".pth"), weights, cfg.to_dict())
                    if periodic:
                        copy_train_checkpoint(cfg.save_dir, latest, self._ckpt_name(f"epoch_{epoch + 1}"))
                        prune_periodic(cfg.save_dir, cfg.keep_checkpoints, self.tag)
            except Exception as e:
                # arrive all the same, so the other processes fail now, not at the timeout
                multihost.barrier(done_tag, error=f"checkpoint write failed: {type(e).__name__}: {e}")
                raise
            multihost.barrier(done_tag)  # the store's barrier: safe on the writer thread

        payload = self._whole_payload()
        if self.writer is None:
            write(payload)
            return
        self.writer.submit("periodic" if periodic else ("best" if is_best else "latest"), self.state, write,
                           payload=payload)

    def _param_names(self) -> List[str]:
        return [k for k, _ in self.state.model.named_parameters()]

    def _whole_payload(self) -> dict:
        """The state's checkpoint payload in the whole reference layout: on a
        model axis the shards gathered over the model group, here on the
        training thread (every rank, in save order)."""
        payload = train_payload(self.state)
        if self._axes is None:
            return payload
        comm = collectives.mesh_comms(self.mesh).model
        return whole_payload(payload, self._axes, self._param_names(), comm)

    def close(self) -> None:
        """Complete queued checkpoint writes and release the writer thread,
        and stop a profiler window still open (idempotent; ``train()`` calls
        it on every exit path)."""
        self.tracer.close()
        if self.writer is not None:
            self.writer.close()

    def _try_resume(self) -> None:
        path = train_checkpoint_path(self.config.save_dir, self._ckpt_name("latest"))
        if not os.path.exists(path):
            self.log.info("resume requested but no latest checkpoint; fresh start")
            return
        local = None
        if self._axes is not None:  # the whole state cut to this rank's shards again
            comm = collectives.mesh_comms(self.mesh).model
            local = lambda p: local_payload(p, self._axes, self._param_names(), comm.rank, comm.size)  # noqa: E731
        meta = load_train_checkpoint(path, self.state, local)
        self.history = meta.get("history", self.history)
        self.best_monitor = meta.get("best_monitor", float("inf"))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        # the loaders' shuffle and augmentation streams are (seed, epoch)
        # derived: replay the order an uninterrupted run would use
        self._epochs_run = self.start_epoch
        for loader in (self.train_loader, self.val_loader, self._stream_train_loader, self._stream_val_loader):
            if loader is not None:
                loader.set_epoch(self.start_epoch)
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
        if "early_stopping" in meta:
            self.early_stopping.load_state_dict(meta["early_stopping"])
        self.log.info("resumed from %s at epoch %d", path, self.start_epoch)

    # -- epochs ------------------------------------------------------------------

    def _device_batches(self, loader: DataLoader):
        """The loader's batches on the device; decoding and copies start now."""

        def host_batches():
            for batch in loader:
                # the global batch's unpadded samples (a process's rows hold a share)
                batch.setdefault("n_real", float(np.sum(batch["weight"])))
                yield cut_d_slab(batch, self.mesh)

        return prefetch_to_device(host_batches(), self.device, self.dtype, size=self.config.prefetch)

    def _consume_loss(self, step_idx: int, loss: torch.Tensor, losses: list, n_total: int) -> None:
        """Fetch a step's loss (one step late), abort on non-finite, log."""
        value = float(loss)
        if not math.isfinite(value):
            raise FloatingPointError(
                f"non-finite training loss ({value}) at batch {step_idx} — aborting instead "
                "of training on"
            )
        losses.append(value)
        cfg = self.config
        if cfg.log_frequency and step_idx % max(cfg.log_frequency, 1) == 0:
            self.log.debug("batch %d: loss %.4f", step_idx, value)
        if cfg.print_frequency and (step_idx + 1) % max(cfg.print_frequency, 1) == 0:
            self.log.info(
                "batch %d/%s: loss %.4f (%.2f vol/s)",
                step_idx + 1, n_total or "?", value, self.timer.items_per_sec,
            )

    def _index_batches(self, indices, shuffle: bool, epoch: int):
        """Padded (case indices, weights) batches of the cached path: the plan
        the streamed loader draws (``default_rng(seed + epoch)``, ``_padded_plan``)."""
        order = list(indices)
        if shuffle:
            np.random.default_rng(self.config.seed + epoch).shuffle(order)
        bs = self.config.batch_size
        for i in range(0, len(order), bs):
            picked, weights = _padded_plan(order[i : i + bs], self._pad_to)
            yield np.asarray(picked, np.int64), np.asarray(weights, np.float32)

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        """Case indices -> rows of the (partial) cache's stacks."""
        if not self._dcache_partial:
            return idx
        return np.asarray([self._dcache_row[int(i)] for i in idx], np.int64)

    def _train_epoch_cached(self) -> float:
        """One epoch from the stacks; under the partial cache the n_s streamed
        batches are spread over the n_c + n_s steps (Bresenham), so their
        decode and copies overlap the cached steps (``trainer.py:600-668``)."""
        cache = self._dcache
        epoch = self._epochs_run
        gen = torch.Generator().manual_seed(self.config.seed * 9973 + epoch)
        losses: List[float] = []
        cached = self._res_train if self._dcache_partial else self.train_indices
        n_c = -(-len(cached) // self.config.batch_size)
        n_s = len(self._stream_train_loader) if self._stream_train_loader is not None else 0
        # the remainder's decode and copies start now, under the cached steps
        stream_iter = self._device_batches(self._stream_train_loader) if n_s else None
        n_total = n_c + n_s
        cached_iter = self._index_batches(cached, True, epoch)
        pending = None  # (step_idx, loss) of the step in flight
        err = 0
        for step_idx in range(n_total):
            self.tracer.on_step(step_idx)
            err += n_s
            if err >= n_total:
                err -= n_total
                batch = next(stream_iter)
                n = int(batch["n_real"])
                self.timer.start()
                metrics = self._train_step(self.state, batch)
            else:
                idx, weights = next(cached_iter)
                n = int(weights.sum())
                self.timer.start()
                metrics = self._cached_train_step(
                    self.state, cache["images"], cache["labels"], self._rows(idx), weights, gen
                )
            if pending is not None:
                self._consume_loss(*pending, losses, n_total)
            pending = (step_idx, metrics["loss"])
            self.timer.stop(items=n)
        if pending is not None:
            self._consume_loss(*pending, losses, n_total)
        self.tracer.close()  # flush if the epoch was shorter than the window
        return float(np.mean(losses)) if losses else float("nan")

    def train_epoch(self) -> float:
        if self._dcache is not None:
            try:
                return self._train_epoch_cached()
            finally:
                self._epochs_run += 1
        losses: List[float] = []
        n_total = len(self.train_loader)
        pending = None  # (step_idx, loss) of the step in flight
        for step_idx, batch in enumerate(self._device_batches(self.train_loader)):
            self.tracer.on_step(step_idx)
            self.timer.start()
            metrics = self._train_step(self.state, batch)
            if pending is not None:
                self._consume_loss(*pending, losses, n_total)
            pending = (step_idx, metrics["loss"])
            self.timer.stop(items=int(batch["n_real"]))
        if pending is not None:
            self._consume_loss(*pending, losses, n_total)
        self.tracer.close()  # flush if the epoch was shorter than the window
        return float(np.mean(losses)) if losses else float("nan")

    def validate_epoch(self) -> Dict[str, float]:
        """Loss and weighted Dice/IoU over the val cases: under the cache the
        resident rows first, then the streamed remainder (``trainer.py:710-780``)."""
        def fetch(m):
            return {k: float(m[k]) for k in ("loss", "dice_sum", "iou_sum", "weight_sum")}

        fetched = []
        streamed = self.val_loader
        if self._dcache is not None:
            cache = self._dcache
            resident = self._res_val if self._dcache_partial else self.val_indices
            for idx, weights in self._index_batches(resident, False, 0):
                fetched.append(fetch(
                    self._cached_eval_step(self.state, cache["images"], cache["labels"], self._rows(idx), weights)
                ))
            streamed = self._stream_val_loader
        if streamed is not None:
            fetched += (fetch(self._eval_step(self.state, batch)) for batch in self._device_batches(streamed))
        w_sum = sum(m["weight_sum"] for m in fetched)
        return {
            "loss": float(np.mean([m["loss"] for m in fetched])) if fetched else float("nan"),
            "dice": sum(m["dice_sum"] for m in fetched) / max(w_sum, 1.0),
            "iou": sum(m["iou_sum"] for m in fetched) / max(w_sum, 1.0),
        }

    def train(self) -> Dict[str, List[float]]:
        try:
            return self._train()
        finally:
            # on every exit path (a non-finite loss, a writer failure): the
            # queued writes complete and the writer thread is released
            self.close()

    def _train(self) -> Dict[str, List[float]]:
        cfg = self.config
        self.log.info(
            "training %d cases (val: %s) for %d epochs, batch %d on %s, mesh %s",
            len(self.train_indices), len(self.val_indices) if self.val_indices else 0,
            cfg.num_epochs, cfg.batch_size, self.device, self.mesh.shape,
        )
        # the schedule's current rate, not config.learning_rate: under warmup
        # (or a resume mid-decay) the first epoch's LR differs
        set_learning_rate(self.state, self.scheduler.lr)
        for epoch in range(self.start_epoch, cfg.num_epochs):
            train_loss = self.train_epoch()
            self.history["train_loss"].append(train_loss)
            if self.val_loader is not None:
                val = self.validate_epoch()
                self.history["val_loss"].append(val["loss"])
                self.history.setdefault("val_dice", []).append(val["dice"])
                self.history.setdefault("val_iou", []).append(val["iou"])
                monitor = val["loss"]
                self.log.info(
                    "epoch %d: train %.4f val %.4f dice %.4f iou %.4f lr %.2e (%.2f vol/s)",
                    epoch, train_loss, val["loss"], val["dice"], val["iou"],
                    self.scheduler.lr, self.timer.items_per_sec,
                )
            else:
                monitor = train_loss
                self.log.info(
                    "epoch %d: train %.4f lr %.2e (%.2f vol/s)",
                    epoch, train_loss, self.scheduler.lr, self.timer.items_per_sec,
                )
            set_learning_rate(self.state, self.scheduler.step(monitor))
            self._drain_saves()  # a writer failure surfaces at the epoch boundary
            # best_monitor moves before the latest save, so a resume from
            # latest(e) never re-awards 'best' to a worse later epoch
            is_best = monitor < self.best_monitor
            if is_best:
                self.best_monitor = monitor
            self._save_epoch(epoch, monitor, is_best)
            if cfg.early_stopping and self.early_stopping.step(monitor):
                self.log.info("early stopping at epoch %d", epoch)
                break
        self._drain_saves(wait=True)
        return self.history

    def _drain_saves(self, wait: bool = False) -> None:
        """Raise an asynchronous write's failure; with ``wait``, first let
        every queued write finish."""
        if self.writer is not None:
            self.writer.drain(wait)
