"""Training traffic for nnU-Net's 3d_fullres: the program's cached train step
with ``model='nnunet'`` and Nesterov SGD, driven over a cohort resident on
the card as ``drivers/train.py`` drives the U-Net's (the same batch order,
window, loss fetch after the next step is queued, and closing sync).

Set-up makes the cohort from the seed and the initial weights from the seed
through the plain reference (``reference/nnunet.py``), builds the train
state and step through the program's model factory, and runs the first
``first_steps`` steps through the window's own call on rows that all
differ; the reference follows those steps from the same weights once the
window has closed.

``correct`` compares, for every trained leaf, the norm of the difference
‖program − reference‖ / max(‖reference‖, the median leaf's ‖reference‖) of
the first step's gradient as SGD took it (its momentum buffer, g + wd·p)
and of the state's change over the first steps: ``grad_gap`` and
``change_gap`` at the worst leaf; the same norm of the difference over the
segmentation heads' change at once, ‖program − reference‖ / ‖reference‖
(``head_gap``); and the non-finite losses of the window. The difference of
the norms, which ``drivers/train.py`` compares, cannot see a change of
direction such as half a batch left out; without BatchNorm nothing couples
the samples here to hide it. The worst leaf reads bf16's rounding of dy
before the InstanceNorms' backward at the 4³ and 8³ stages (~0.45 in a
sound run), so a fault that changes every layer a little, such as
LeakyReLU's slope set to 0, hides there. A head's gradient passes through
no norm's backward: the features times the loss's gradient, summed over
every voxel of its scale, so the heads read bf16's rounding at ~0.1% and
any change of the forward or of the loss well above it."""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers.train import batch_order
from benchmark.lib import nnunet_shapes, synth
from benchmark.lib.harness import Cell, Check, Outcome, Readings
from benchmark.lib.trace import DeviceTrace
from benchmark.reference import nnunet as ref

HEADS = "decoder.seg_layers."  # the segmentation heads' parameters
PORT_KEYS = ("model", "nnunet_features", "n_classes", "target_size", "compute_dtype", "param_dtype", "batch_size",
             "accum_steps", "remat", "deep_supervision", "loss", "bce_weight", "dice_weight", "dice_smooth",
             "optimizer", "learning_rate", "weight_decay", "grad_clip_norm", "threshold",
             "normalize", "norm_percentiles")


def port_config(config: dict):
    """The program's Config for the configuration file: its settings, no
    EMA, no augmentation, the whole cohort cached."""
    from pcmseg_tpu_torch.core.config import get_config

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items() if k in PORT_KEYS}
    return get_config("standard", ema_decay=0.0, data_augmentation=False, train_crop=None, **kw)


def ref_config(config: dict) -> dict:
    """The reference's settings: the file's, the features as a tuple."""
    return dict(config, nnunet_features=tuple(config["nnunet_features"]))


def init_state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return ref.init_state(ref_config(config), seed, device)


def leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """For each leaf of ``want``, ‖prog − want‖ / max(‖want‖, the median
    leaf's ‖want‖), in float64; a leaf the program has none of reads as
    zeros."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    out = {}
    for k, w in want.items():
        p = prog.get(k)
        diff = w.double() if p is None else p.double() - w.double()
        out[k] = float(diff.norm()) / max(norms[k], med, 1e-30)
    return out


class Program:
    """The program under test after set-up: its model, train state and
    cached step over the cohort, the batch order, and its readings of the
    first steps (losses, the first gradient as SGD took it and the state's
    change, per trained leaf, kept whole)."""

    def __init__(self, cell: Cell):
        from pcmseg_tpu_torch.data import device_cache
        from pcmseg_tpu_torch.models import build_model
        from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

        cfg, traffic, dev = cell.config, cell.traffic, torch.device(cell.device)
        pcfg = port_config(cfg)
        size, bs = tuple(cfg["target_size"]), cfg["batch_size"]
        self.images, self.labels = synth.cohort(cell.seed, traffic["cohort"], size, cfg["n_modalities"],
                                                cfg["n_classes"], dev)
        init = init_state(cfg, cell.seed + 1, dev)
        self.model = build_model(pcfg, deep_supervision=pcfg.deep_supervision, device="meta")
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
            if i == 0:  # the gradient as SGD took it: its momentum buffer
                grad1 = {names[id(p)]: s["momentum_buffer"].detach().clone()
                         for p, s in self.state.optimizer.state.items()}
        trained = {k for k, p in self.model.named_parameters() if p.requires_grad}
        change = {k: (v - init[k]).detach() for k, v in self.model.state_dict().items() if k in trained}
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
    features, mods = tuple(cfg["nnunet_features"]), cfg["n_modalities"]
    readings.counters = {"steps": steps}
    readings.work = {
        "flop": float(nnunet_shapes.train_flop(features, mods, cfg["n_classes"], size, samples)),
        "b1_bound_s": samples * nnunet_shapes.b1_bound_s(features, mods, size),
        "b2_bound_s": samples * nnunet_shapes.b2_bound_s(features, mods, size),
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


def reference_readings(cfg: dict, seed: int, dev, batches, prec: ref.Precision = ref.FP32, **fault):
    """(step losses, the first gradient as SGD took it, the state's change)
    of the reference over ``batches`` from the seed's weights, per trained
    leaf; ``fault`` (``slope``, ``groups``) plants a fault in it."""
    init = init_state(cfg, seed + 1, dev)
    state = {k: v.clone() for k, v in init.items()}
    with ref.no_tf32():
        losses, grad1 = ref.train_steps(state, batches, ref_config(cfg), prec, **fault)
    change = {k: state[k].detach() - init[k] for k in grad1}
    return losses, grad1, change


def state_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """‖prog − want‖ / ‖want‖ over every leaf of ``want`` at once, in
    float64 (a leaf the program has none of reads as zeros)."""
    diff = sum(float((want[k].double() - (prog[k].double() if k in prog else 0.0)).square().sum()) for k in want)
    return math.sqrt(diff / max(sum(float(w.double().square().sum()) for w in want.values()), 1e-300))


def gaps(prog, reference, leaves: bool = False) -> Dict[str, float]:
    """The numbers that decide ``correct``, of readings ``prog`` against the
    reference's: the relative gap of the first step's loss and the largest
    of every step's (read, not compared); the worst and the median leaf's
    difference-based gap of the first gradient (``grad_gap``) and of the
    state's change (``change_gap``); and the gap of the segmentation heads'
    change over the first steps (``head_gap``), of the whole state's change
    (``state_gap``) and of the whole first gradient (``grad_state_gap``),
    each over its leaves at once. With ``leaves`` the worst leaves' names
    come too."""
    (losses, grad1, change), (r_losses, r_grad, r_change) = prog, reference
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, r_losses)]
    grad, moved = leaf_gaps(grad1, r_grad), leaf_gaps(change, r_change)
    out = {"loss1_gap": rel[0], "loss_gap": max(rel), "grad_gap": max(grad.values()),
           "grad_median_gap": float(np.median(list(grad.values()))), "change_gap": max(moved.values()),
           "change_median_gap": float(np.median(list(moved.values()))),
           "head_gap": state_gap(change, {k: v for k, v in r_change.items() if k.startswith(HEADS)}),
           "state_gap": state_gap(change, r_change), "grad_state_gap": state_gap(grad1, r_grad)}
    if leaves:
        out.update(grad_leaf=max(grad, key=grad.get), change_leaf=max(moved, key=moved.get))
    return out


def first_rows(cell: Cell) -> List[tuple]:
    """The first steps' batches as the program draws them, without the
    program: the cohort from the seed and the batch order's first rows."""
    cfg = cell.config
    images, labels = synth.cohort(cell.seed, cell.traffic["cohort"], tuple(cfg["target_size"]),
                                  cfg["n_modalities"], cfg["n_classes"], cell.device)
    order = batch_order(cell.seed, cell.traffic["cohort"], cfg["batch_size"])
    rows = [next(order) for _ in range(cell.traffic["first_steps"])]
    return [(images[r].clone(), labels[r].clone()) for r in rows]
