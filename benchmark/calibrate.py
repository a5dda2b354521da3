"""Readings that the limits of ``correct`` are set from, over many seeds in
one process at a cell's own size:

    python3 benchmark/calibrate.py --workload NAME --seeds 11,12,13 --what program|faults

``program`` (training cells): the program's first steps against the
reference, every number a run can compare. ``faults``: the control (the
reference computed in int8, a precision below the configuration's bf16:
``reference/unet3d.py`` ``Precision``), the same in fp8, and a planted fault (training: half of the batch left
out, the mean taken over the rest; serving: half of the TTA flips left out)
against the float32 reference. The program's readings of a serving cell
come from its runs. One JSON line per seed."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if not __package__:  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.lib import harness, synth  # noqa: E402
from benchmark.reference import unet3d as ref  # noqa: E402

CONTROL = ref.Precision("int8")  # the control of every cell
FP8 = ref.Precision("fp8")  # read beside it: it does not separate in bn_train_b4


def train_rows(cell):
    from benchmark.drivers import train

    cfg = cell.config
    images, labels = synth.cohort(cell.seed, cell.traffic["cohort"], tuple(cfg["target_size"]),
                                  cfg["n_modalities"], cfg["n_classes"], cell.device)
    order = train.batch_order(cell.seed, cell.traffic["cohort"], cfg["batch_size"])
    rows = [next(order) for _ in range(cell.traffic["first_steps"])]
    return [(images[r].clone(), labels[r].clone()) for r in rows]


def train_readings(cell, what):
    from benchmark.drivers import train

    cfg, dev = cell.config, torch.device(cell.device)
    if what == "program":
        program = train.Program(cell)
        batches, readings = program.first_batches(), program.readings
        del program
        gc.collect()
        torch.cuda.empty_cache()
        return {"program": train.gaps(readings, train.reference_readings(cfg, cell.seed, dev, batches), leaves=True)}
    batches = train_rows(cell)
    r32 = train.reference_readings(cfg, cell.seed, dev, batches)
    rc = train.reference_readings(cfg, cell.seed, dev, batches, CONTROL)
    r8 = train.reference_readings(cfg, cell.seed, dev, batches, FP8)
    half_cfg = dict(cfg, accum_steps=cfg["accum_steps"] // 2, batch_size=cfg["batch_size"] // 2)
    half = train.reference_readings(half_cfg, cell.seed, dev, [(i[: len(i) // 2], l[: len(l) // 2])
                                                              for i, l in batches])
    return {"control": train.gaps(rc, r32, leaves=True), "fp8": train.gaps(r8, r32, leaves=True),
            "half_batch": train.gaps(half, r32, leaves=True)}


def serve_readings(cell, what):
    from benchmark.drivers import serve

    if what != "faults":
        raise SystemExit("a serving cell's program readings come from its runs")
    cfg, traffic, dev = cell.config, cell.traffic, torch.device(cell.device)
    members = serve.member_states(serve.member_paths(cfg, traffic, dev), dev)
    volumes, _ = serve.case_pool(cell.seed, traffic["pool"], tuple(cfg["target_size"]), cfg["n_modalities"], dev)
    rng = np.random.default_rng(cell.seed + 7)
    out = {"control": 0.0, "fp8": 0.0, "half_flips": 0.0}
    for i in rng.choice(traffic["pool"], size=traffic["sample"], replace=False):
        p32 = serve.reference_probabilities(cfg, traffic, dev, volumes[i], members)
        pc = serve.reference_probabilities(cfg, traffic, dev, volumes[i], members, CONTROL)
        p8 = serve.reference_probabilities(cfg, traffic, dev, volumes[i], members, FP8)
        saved = ref.FLIPS[:]
        ref.FLIPS[:] = saved[::2]  # four of the eight flips, the mean over them
        try:
            ph = serve.reference_probabilities(cfg, traffic, dev, volumes[i], members)
        finally:
            ref.FLIPS[:] = saved
        t = cfg["threshold"]
        out["control"] = max(out["control"], serve.mask_gap((pc > t).astype(np.uint8), p32, t))
        out["fp8"] = max(out["fp8"], serve.mask_gap((p8 > t).astype(np.uint8), p32, t))
        out["half_flips"] = max(out["half_flips"], serve.mask_gap((ph > t).astype(np.uint8), p32, t))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", choices=("program", "faults"), required=True)
    args = p.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, 0.0, False)
        t0 = time.perf_counter()
        read = train_readings if cell.traffic["driver"] == "train" else serve_readings
        line = {"workload": cell.name, "seed": seed, **read(cell, args.what),
                "seconds": time.perf_counter() - t0, "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
