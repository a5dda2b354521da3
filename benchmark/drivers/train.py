"""Training traffic: the program's cached train step driven over a cohort
resident on the card, as the Trainer's epoch loop drives it.

Set-up makes the cohort and the initial weights from the seed, builds one
train state and step, and runs its first ``first_steps`` steps through the
window's own call on rows that all differ; the plain reference follows
those steps from the same weights once the window has closed. The window
dispatches shuffled batches with no sync but the Trainer's own (each
step's loss fetched after the next step is queued) and is closed by one
``torch.cuda.synchronize()``."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import flops, synth
from benchmark.lib.harness import Cell, Check, Outcome, Readings
from benchmark.lib.trace import DeviceTrace
from benchmark.reference import unet3d as ref

PORT_KEYS = ("n_classes", "base_features", "norm_layer", "group_norm_groups", "target_size", "compute_dtype",
             "param_dtype", "batch_size", "accum_steps", "remat", "loss", "learning_rate", "betas", "eps",
             "weight_decay", "grad_clip_norm", "threshold", "normalize", "norm_percentiles")


def port_config(config: dict):
    """The program's Config for a configuration file: the high_performance
    preset with the file's settings, no EMA, the whole cohort cached."""
    from pcmseg_tpu_torch.core.config import get_config

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items() if k in PORT_KEYS}
    return get_config("high_performance", ema_decay=0.0, data_augmentation=False, train_crop=None, **kw)


def batch_order(seed: int, n: int, batch: int):
    """Batches of case rows: a fresh permutation of the cohort each epoch."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            yield perm[i:i + batch]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items() if v.is_floating_point()}


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """For each of ``keys``, |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖); a leaf the program has no reading of reads 0."""
    med = float(np.median([refn[k] for k in keys]))
    return {k: abs(prog.get(k, 0.0) - refn[k]) / max(refn[k], med, 1e-30) for k in keys}


class Program:
    """The program under test after set-up: its model, train state and
    cached step over the cohort, the batch order, and its readings of the
    first steps (losses, per-leaf norms of the first gradient and of the
    state's change)."""

    def __init__(self, cell: Cell):
        from pcmseg_tpu_torch.data import device_cache
        from pcmseg_tpu_torch.models.unet3d import UNet3D
        from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

        cfg, traffic, dev = cell.config, cell.traffic, torch.device(cell.device)
        pcfg = port_config(cfg)
        size, bs = tuple(cfg["target_size"]), cfg["batch_size"]
        self.images, self.labels = synth.cohort(cell.seed, traffic["cohort"], size, cfg["n_modalities"],
                                                cfg["n_classes"], dev)
        init = synth.init_state(cfg, cell.seed + 1, dev)
        self.model = UNet3D.from_config(pcfg, device="meta")
        self.model.load_state_dict({k: v.clone() for k, v in init.items()}, strict=True, assign=True)
        self.state = create_train_state(self.model, pcfg)
        self.step = device_cache.make_cached_train_step(pcfg, make_train_step(self.model, pcfg))
        self.weights = np.ones(bs, np.float32)
        self.gen = torch.Generator().manual_seed(cell.seed % 2 ** 63)
        self.order = batch_order(cell.seed, traffic["cohort"], bs)
        names = {id(p): k for k, p in self.model.named_parameters()}

        # the first steps, through the window's own call, on rows that all differ
        self.first_rows, losses, grad1 = [], [], None
        for i in range(traffic["first_steps"]):
            idx = next(self.order)
            self.first_rows.append(idx)
            losses.append(float(self(idx)["loss"]))
            if i == 0:  # the gradient as Adam took it: m₁ / (1 − β₁)
                b1 = self.state.optimizer.param_groups[0]["betas"][0]
                grad1 = _norms({names[id(p)]: s["exp_avg"] / (1 - b1)
                                for p, s in self.state.optimizer.state.items()})
        change = _norms({k: v - init[k] for k, v in self.model.state_dict().items() if v.is_floating_point()})
        self.readings = (losses, grad1, change)

    def __call__(self, idx):
        return self.step(self.state, self.images, self.labels, idx, self.weights, self.gen)

    def first_batches(self):
        """Copies of the first steps' rows, for the reference."""
        return [(self.images[r].clone(), self.labels[r].clone()) for r in self.first_rows]


def run(cell: Cell) -> Outcome:
    cfg, dev = cell.config, torch.device(cell.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size, bs = tuple(cfg["target_size"]), cfg["batch_size"]
    program = Program(cell)
    sync()

    readings = Readings()
    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    spans = readings.spans
    steps, losses, pending = 0, [], None
    t0, t0_ns = time.perf_counter(), time.time_ns()
    while time.perf_counter() - t0 < cell.seconds:
        with spans.span("gather"):
            idx = next(program.order)
        with spans.span("step"):
            metrics = program(idx)
        steps += 1
        if pending is not None:
            with spans.span("sync"):
                losses.append(float(pending))
        pending = metrics["loss"]
    with spans.span("sync"):
        losses.append(float(pending))
        sync()
    t1, t1_ns = time.perf_counter(), time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)
        readings.trace = DeviceTrace.from_profiler(prof, t0_ns, t1_ns)
    readings.window_start_ns, readings.window_end_ns = t0_ns, t1_ns
    samples = steps * bs
    base, mods = cfg["base_features"], cfg["n_modalities"]
    readings.counters = {"steps": steps}
    readings.work = {
        "flop": float(flops.train_flop(base, mods, cfg["n_classes"], size, samples)),
        "b1_bound_s": samples * (flops.forward_bound(base, mods, size) + flops.dx_bound(base, mods, size)),
        "b2_bound_s": samples * flops.dw_bound(base, mods, size),
    }
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the program's state freed, then the reference follows the first steps
    batches, prog_readings = program.first_batches(), program.readings
    del program, metrics, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = gaps(prog_readings, reference_readings(cfg, cell.seed, dev, batches))
    found["nonfinite_losses"] = float(sum(not math.isfinite(x) for x in losses))
    return Outcome(attempted=steps, failed=0, window_start=t0,
                   end_to_end={"train_vol_s": samples / (t1 - t0)}, readings=readings,
                   checks=[Check(k, v, cell.limits[k]) for k, v in found.items() if k in cell.limits],
                   memory_peak_bytes=memory_peak, found=found)


def reference_readings(cfg: dict, seed: int, dev, batches, prec: ref.Precision = ref.FP32):
    """(step losses, per-leaf norms of the first gradient and of the state's
    change) of the reference over ``batches`` from the seed's weights."""
    init = synth.init_state(cfg, seed + 1, dev)
    state = {k: v.clone() for k, v in init.items()}
    with ref.no_tf32():
        losses, grad1 = ref.train_steps(state, batches, cfg, prec)
    change = _norms({k: state[k].detach() - init[k] for k in state if state[k].is_floating_point()})
    return losses, _norms(grad1), change


def gaps(prog, reference, leaves: bool = False) -> Dict[str, float]:
    """The numbers that decide ``correct``, of readings ``prog`` against the
    reference's: the relative gap of the first step's loss (the forward at
    the same weights) and the largest of every step's; the worst and the
    median leaf's gap between the norms of the first gradient; the worst
    and the median leaf's gap between the norms of the state's change over
    the first steps (the BatchNorm running statistics among the leaves). Both leave out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's: their gradient is round-off (a conv's bias under BatchNorm),
    and Adam moves them by it alone. With ``leaves`` the worst leaves' names
    come too."""
    (losses, grad1, change), (r_losses, r_grad, r_change) = prog, reference
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, r_losses)]
    med = float(np.median(list(r_grad.values())))
    moved = [k for k in r_grad if r_grad[k] >= 1e-3 * med]
    grad = leaf_gaps(grad1, r_grad, moved)
    change = leaf_gaps(change, r_change, moved + [k for k in r_change if "running_" in k])
    out = {"loss1_gap": rel[0], "loss_gap": max(rel), "grad_gap": max(grad.values()),
           "grad_median_gap": float(np.median(list(grad.values()))), "change_gap": max(change.values()),
           "change_median_gap": float(np.median(list(change.values())))}
    if leaves:
        out.update(grad_leaf=max(grad, key=grad.get), change_leaf=max(change, key=change.get))
    return out
