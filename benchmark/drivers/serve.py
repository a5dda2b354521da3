"""Serving traffic: the program's PredictionServer polling an inbox that
the benchmark fills with 128³ five-modality NIfTI cases.

Set-up writes the fold members' ``.pth`` files once per checkout (from the
mix's fixed weight seed, into ``benchmark/.cache``), writes a pool of
distinct cases from ``--seed`` into the run's temporary directory, starts
the server on the members and serves one case to warm every shape. In the
window the benchmark queues cases, each a new directory of hard links to a
pool case renamed into the inbox whole: under ``arrivals: backlog``
``pending`` cases wait when the window opens and enough are added that as
many always wait; under ``arrivals: spaced`` one at each
of evenly spaced due times (``rate_case_s``), open loop. A case's latency
runs from its due time to the return of the call that renamed its mask
into place. The rate counts the cases written in the window and the share
of the case in progress at its close that was done by then. Once the window has closed the server is stopped, and the
reference recomputes the masks of a sample of the served pool cases."""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import flops, nifti, stats, synth
from benchmark.lib.harness import BENCH_DIR, Cell, Check, Outcome, Readings
from benchmark.lib.trace import DeviceTrace
from benchmark.reference import unet3d as ref

SPACING = (0.5, 0.5, 1.5)  # x, y, z in mm: a prostate T2 grid
CACHE = BENCH_DIR / ".cache"  # the members' files, kept across the runs in a checkout
SNAPSHOT_KEYS = ("n_modalities", "n_classes", "base_features", "norm_layer", "group_norm_groups", "modalities",
                 "normalize", "norm_percentiles", "target_size")


def member_paths(config: dict, traffic: dict, device) -> List[str]:
    """The members' ``.pth`` files, written on a checkout's first run: each
    from its own seed, BatchNorm's scales, shifts and statistics drawn as a
    trained model has them, and every head's bias moved by one shift, so
    that the ensemble's flip-averaged probability on a calibration case
    (from the weight seed) exceeds the threshold on the share
    ``foreground`` of the voxels, a lesion's share of the volume. A trained
    model's probabilities straddle the threshold along a lesion's boundary;
    a random one's sit far from it, where no error of precision shows."""
    key = json.dumps([{k: config[k] for k in SNAPSHOT_KEYS}, traffic["weight_seed"], traffic["foreground"],
                      traffic["members"], traffic["tta"]], sort_keys=True)
    out_dir = CACHE / f"{config['name']}-{hashlib.sha256(key.encode()).hexdigest()[:12]}"
    paths = [out_dir / f"member{i}.pth" for i in range(traffic["members"])]
    if all(p.exists() for p in paths):
        return [str(p) for p in paths]
    out_dir.mkdir(parents=True, exist_ok=True)
    members = [synth.init_state(config, traffic["weight_seed"] + i, device, True) for i in range(traffic["members"])]
    volume, _ = case_pool(traffic["weight_seed"], 1, tuple(config["target_size"]), config["n_modalities"], device)
    x = _normalized(config, volume[0], device)
    with torch.no_grad(), ref.no_tf32():
        logits = torch.cat([torch.flip(ref.forward(sd, torch.flip(x, axes) if axes else x, config["norm_layer"],
                                                   config["group_norm_groups"]), axes)
                            for sd in members for axes in (ref.FLIPS if traffic["tta"] else [()])])
    sample = logits[:, 0].flatten(1)[:, ::7]
    lo, hi = -100.0, 100.0  # the shift δ: the (1 − foreground) quantile of mean σ(logit + δ) is the threshold
    for _ in range(60):
        mid = (lo + hi) / 2
        p = torch.sigmoid(sample + mid).mean(0)
        if torch.quantile(p, 1.0 - traffic["foreground"]) > config["threshold"]:
            hi = mid
        else:
            lo = mid
    snap = {k: config[k] for k in SNAPSHOT_KEYS}
    for sd, path in zip(members, paths):
        sd["outc.bias"] += (lo + hi) / 2
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save({"model_state_dict": {k: v.cpu() for k, v in sd.items()}, "config": snap}, tmp)
        os.replace(tmp, path)
    return [str(p) for p in paths]


def member_states(paths: List[str], device) -> List[Dict[str, torch.Tensor]]:
    """The members' state dicts, read from their files."""
    return [{k: v.to(device) for k, v in torch.load(p, map_location="cpu", weights_only=True)
             ["model_state_dict"].items()} for p in paths]


def _normalized(config: dict, volume: np.ndarray, device) -> torch.Tensor:
    """(1, C, D, H, W) float32: each channel of a raw case normalized by the reference."""
    x = np.stack([ref.percentile_normalize(c, *config["norm_percentiles"]) for c in volume])
    return torch.from_numpy(x)[None].to(device)


def case_pool(seed: int, n: int, size, n_modalities: int, device):
    """``n`` distinct raw cases: (n, C, D, H, W) int16 intensities (a smooth
    field over 0..2000 with noise and a brighter lesion) and each case's
    affine (the grid's origin moved by the seed)."""
    gen = synth.generator(seed, device)
    d, h, w = size
    coarse = torch.rand((n * n_modalities, 1, 8, 8, 8), generator=gen, device=device)
    field = torch.nn.functional.interpolate(coarse, size=size, mode="trilinear", align_corners=False)
    field = field.view(n, n_modalities, d, h, w)
    grid = torch.stack(torch.meshgrid(*(torch.arange(s, device=device, dtype=torch.float32) for s in size),
                                      indexing="ij"))
    centre = (0.3 + 0.4 * torch.rand((n, 3, 1, 1, 1), generator=gen, device=device)) * torch.tensor(
        size, device=device, dtype=torch.float32).view(1, 3, 1, 1, 1)
    radius = 10 + 14 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    lesion = ((grid[None] - centre).norm(dim=1) < radius).float()[:, None]
    noise = torch.randn((n, n_modalities, d, h, w), generator=gen, device=device)
    raw = 300 + 1200 * field + 400 * lesion + 60 * noise
    volumes = raw.clamp(0, 32767).round().to(torch.int16).cpu().numpy()
    origins = (torch.randint(-80, 80, (n, 3), generator=gen, device=device).float() * 0.5).cpu().numpy()
    affines = []
    for o in origins:
        a = np.diag([*SPACING, 1.0])
        a[:3, 3] = o
        affines.append(a)
    return volumes, affines


def write_pool(root: Path, volumes, affines, modalities) -> List[Path]:
    dirs = [root / f"pool{i}" for i in range(len(volumes))]
    jobs = []
    for case, vol, aff in zip(dirs, volumes, affines):
        for m, channel in zip(modalities, vol):
            (case / m).mkdir(parents=True)
            jobs.append((case / m / "image.nii.gz", channel, aff))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda j: nifti.write(str(j[0]), j[1], j[2]), jobs))
    return dirs


def queue_case(src: Path, staging: Path, inbox: Path, name: str) -> None:
    """A new case directory of hard links to ``src``, renamed into the inbox whole."""
    case = staging / name
    for m in sorted(os.listdir(src)):
        (case / m).mkdir(parents=True)
        for f in os.listdir(src / m):
            os.link(src / m / f, case / m / f)
    os.rename(case, inbox / name)


def run(cell: Cell) -> Outcome:
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.serve import PredictionServer

    cfg, traffic, dev = cell.config, cell.traffic, torch.device(cell.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size = tuple(cfg["target_size"])
    paths = member_paths(cfg, traffic, dev)
    work = Path(tempfile.mkdtemp(prefix="bench-serve-"))
    try:
        volumes, affines = case_pool(cell.seed, traffic["pool"], size, cfg["n_modalities"], dev)
        pool = write_pool(work / "pool", volumes, affines, cfg["modalities"])
        inbox, outbox, staging = work / "inbox", work / "out", work / "staging"
        for d in (inbox, outbox, staging):
            d.mkdir()
        pcfg = get_config("standard", tta=traffic["tta"], threshold=cfg["threshold"],
                          modalities=tuple(cfg["modalities"]), normalize=cfg["normalize"],
                          norm_percentiles=tuple(cfg["norm_percentiles"]), compute_dtype=cfg["compute_dtype"],
                          target_size=size)
        server = PredictionServer(pcfg, paths, str(inbox), str(outbox), min_age=0.0, device=dev)
        readings = Readings()
        spans = readings.spans
        done: Dict[str, float] = {}  # case -> perf_counter when its mask was in place
        predictor = server.predictor
        predictor.read_case = spans.wrap("decode", predictor.read_case)
        predictor.predict_mask = spans.wrap("forward", predictor.predict_mask)
        save = spans.wrap("write", predictor.save_mask)

        def save_mask(mask, reference, output_path):
            out = save(mask, reference, output_path)
            done[Path(output_path).parent.name] = time.perf_counter()
            return out

        predictor.save_mask = save_mask
        server.process_case = spans.wrap("case", server.process_case)
        queue_case(pool[0], staging, inbox, "warmup")  # every shape of the window, once
        server.run_once()
        sync()
        if server.stats["done"] != 1:
            raise RuntimeError(f"the warm-up case was not served: {server.stats}")
        done.clear()
        spans.by_name.clear()

        rng = np.random.default_rng(cell.seed)
        order = [int(i) for i in rng.permutation(traffic["pool"])]
        due: Dict[str, float] = {}  # case -> due time
        source: Dict[str, int] = {}  # case -> pool index

        def queue(t_due: float) -> None:
            name = f"c{len(due):05d}"
            source[name] = order[len(due) % len(order)]
            queue_case(pool[source[name]], staging, inbox, name)
            due[name] = t_due

        spaced = traffic["arrivals"] == "spaced"
        if not spaced:  # the backlog is in the inbox when the window opens
            for _ in range(traffic["pending"]):
                queue(0.0)
        stop = work / "stop"
        failures: List[BaseException] = []

        def serve():
            try:
                server.run(poll_interval=traffic["poll_s"], stop_file=str(stop))
            except BaseException as e:  # reported after the window
                failures.append(e)

        prof = None
        if cell.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        thread = threading.Thread(target=serve, name="bench-server")
        t0, t0_ns = time.perf_counter(), time.time_ns()
        t_end = t0 + cell.seconds
        for name in due:
            due[name] = t0
        thread.start()
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if spaced:
                t_due = t0 + len(due) / traffic["rate_case_s"]
                if t_due >= t_end:
                    break
                if now < t_due:
                    time.sleep(min(t_due - now, 0.005))
                    continue
                queue(t_due)
            elif len(due) - len(done) < traffic["pending"]:
                queue(now)
            else:
                time.sleep(0.005)
        deadline = time.perf_counter() + 60.0  # every case queued in the window is waited for, a minute at most
        while len(set(due) - set(done)) and time.perf_counter() < deadline and thread.is_alive():
            time.sleep(0.01)
        stop.touch()
        thread.join(timeout=120.0)
        sync()
        t1_ns = time.time_ns()
        if prof is not None:
            prof.__exit__(None, None, None)
            readings.trace = DeviceTrace.from_profiler(prof, t0_ns, t1_ns)
        if thread.is_alive() or failures:
            raise RuntimeError(f"the server did not stop cleanly: {failures or 'still running'}")
        readings.window_start_ns, readings.window_end_ns = t0_ns, t1_ns
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        # the cases written in the window, and the share of the next one done by its close
        written_in_window = [c for c, t in done.items() if c in due and t <= t_end]
        t_end_ns = t0_ns + int(cell.seconds * 1e9)
        open_case = [(t_end_ns - a) / (b - a) for a, b in spans.by_name["case"] if a < t_end_ns < b]
        latencies = [done[c] - due[c] if c in done else math.inf for c in due]
        missing = [c for c in due if c not in done]
        passes = traffic["members"] * (8 if traffic["tta"] else 1)
        forwards = passes * len(spans.durations_s("forward", t0_ns, t1_ns))
        base, mods = cfg["base_features"], cfg["n_modalities"]
        readings.counters = {"forwards": forwards,
                             "latency_s": [server.latencies[c] for c in done if c in server.latencies]}
        readings.work = {"flop": float(forwards * flops.forward_flop(base, mods, cfg["n_classes"], size)),
                         "b1_bound_s": forwards * flops.forward_bound(base, mods, size)}
        end_to_end = {"serve_case_s": stats.rate(len(written_in_window) + sum(open_case), cell.seconds),
                      "serve_p90_ms": 1e3 * stats.percentile(latencies, 90.0) if latencies else math.inf}
        server_failed = server.stats["failed"]
        masks = {c: nifti.read(str(outbox / c / "segmentation.nii.gz")) for c in done}
        del server, predictor
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        found = compare(cfg, traffic, cell.seed, dev, volumes, affines, masks, source, paths)
        found["missing"] = float(len(missing))
        checks = [Check(k, v, cell.limits[k]) for k, v in found.items() if k in cell.limits]
        return Outcome(attempted=len(due), failed=len(missing) + server_failed, window_start=t0,
                       end_to_end=end_to_end, readings=readings, checks=checks, memory_peak_bytes=memory_peak)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def reference_probabilities(cfg: dict, traffic: dict, dev, volume: np.ndarray, members,
                            prec: ref.Precision = ref.FP32) -> np.ndarray:
    """The reference's ensemble + TTA foreground probability (D, H, W) of one
    raw case, from the members' state dicts."""
    with ref.no_tf32():
        p = ref.ensemble_probabilities(members, _normalized(cfg, volume, dev),
                                       cfg["norm_layer"], cfg["group_norm_groups"], traffic["tta"], prec)
    return p[0, 0].cpu().numpy()


def mask_gap(mask: np.ndarray, probs: np.ndarray, threshold: float) -> float:
    """The widest gap |p − threshold| of the reference's probability at a
    voxel where the served mask and the reference's disagree (0 where none do)."""
    wrong = mask.astype(bool) != (probs > threshold)
    return float(np.abs(probs[wrong] - threshold).max()) if wrong.any() else 0.0


def compare(cfg, traffic, seed, dev, volumes, affines, masks, source, paths):
    """The numbers that decide ``correct``: ``mask_gap``, the widest over
    every served copy of a sample of the pool's cases (drawn from the
    seed) of :func:`mask_gap`; ``geometry``, the count of served masks whose
    shape, type or affine differs from their case's."""
    geometry = 0
    for c, (data, affine) in masks.items():
        want = affines[source[c]].astype(np.float32)
        geometry += int(data.shape != volumes.shape[2:] or data.dtype != np.uint8
                        or not np.array_equal(affine.astype(np.float32), want))
    served = sorted({source[c] for c in masks})
    rng = np.random.default_rng(seed + 7)
    sample = [int(i) for i in rng.choice(served, size=min(traffic["sample"], len(served)), replace=False)]
    gap, members = 0.0, member_states(paths, dev)
    for i in sample:
        probs = reference_probabilities(cfg, traffic, dev, volumes[i], members)
        for c, (data, _) in masks.items():
            if source[c] == i:
                gap = max(gap, mask_gap(data, probs, cfg["threshold"]))
    return {"mask_gap": gap, "geometry": float(geometry)}
