"""Readings that the limits of ``nnunet_train_b2``'s ``correct`` are set
from, over many seeds in one process at the cell's own size:

    python3 benchmark/calibrate_nnunet.py --seeds 11,12,13 --what program|faults|planted

``program``: the program's first steps against the reference, every number
a run can compare. ``faults``: against the float32 reference, the control
(the reference computed in int8, a precision below the configuration's
bf16), the same in fp8, and the reference with a fault planted: one of the
two volumes left out (``half_batch``), LeakyReLU's slope 0 (``slope0``),
GroupNorm of 8 groups in InstanceNorm's place (``groupnorm8``). ``planted``:
the program itself with each of those three faults. One JSON line per
seed."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if not __package__:  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark.lib import harness  # noqa: E402
from benchmark.reference import nnunet as ref  # noqa: E402

WORKLOAD = "nnunet_train_b2"
CONTROL = ref.Precision("int8")
FP8 = ref.Precision("fp8")


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


TABLES = []  # per run, per leaf: (‖reference‖, ‖program − reference‖) of the first gradient and of the change


def _gaps(prog, want, what):
    from benchmark.drivers import train_nnunet as drv

    (_, g, c), (_, rg, rc) = prog, want
    norms = lambda a, b: {k: [float(b[k].double().norm()), float((a[k].double() - b[k].double()).norm())]  # noqa: E731
                          for k in b}
    TABLES.append({"what": what, "grad": norms(g, rg), "change": norms(c, rc)})
    return drv.gaps(prog, want, leaves=True)


def program_readings(cell, what="program"):
    from benchmark.drivers import train_nnunet as drv

    program = drv.Program(cell)
    batches, readings = program.first_batches(), program.readings
    del program
    _free()
    return _gaps(readings, drv.reference_readings(cell.config, cell.seed, torch.device(cell.device), batches), what)


def fault_readings(cell):
    from benchmark.drivers import train_nnunet as drv

    cfg, dev = cell.config, torch.device(cell.device)
    batches = drv.first_rows(cell)
    r32 = drv.reference_readings(cfg, cell.seed, dev, batches)
    out = {}
    for name, kw in (("control", dict(prec=CONTROL)), ("fp8", dict(prec=FP8)), ("slope0", dict(slope=0.0)),
                     ("groupnorm8", dict(groups=8))):
        out[name] = _gaps(drv.reference_readings(cfg, cell.seed, dev, batches, **kw), r32, name)
        _free()
    half = [(i[: len(i) // 2], lab[: len(lab) // 2]) for i, lab in batches]
    out["half_batch"] = _gaps(drv.reference_readings(cfg, cell.seed, dev, half), r32, "half_batch")
    return out


def planted(name: str):
    """A context planting fault ``name`` in the program."""
    import contextlib

    from pcmseg_tpu_torch.data import device_cache
    from pcmseg_tpu_torch.models import nnunet

    saved = {}

    @contextlib.contextmanager
    def patch(obj, attr, value):
        saved[(obj, attr)] = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            yield
        finally:
            setattr(obj, attr, saved.pop((obj, attr)))

    if name == "half_batch":
        gather = device_cache.gather_rows
        return patch(device_cache, "gather_rows",
                     lambda images, labels, idx, *a, **k: gather(images, labels, idx[: len(idx) // 2], *a, **k))
    if name == "slope0":
        return patch(nnunet, "NEG_SLOPE", 0.0)
    if name == "groupnorm8":
        return patch(nnunet.InstanceNorm, "forward", lambda self, x: torch.group_norm(
            x.permute(0, 4, 1, 2, 3).contiguous(), min(8, x.shape[-1]), self.weight.to(x.dtype),
            self.bias.to(x.dtype), self.eps, False).permute(0, 2, 3, 4, 1).contiguous())
    raise ValueError(f"unknown fault {name!r}")


def planted_readings(cell):
    out = {}
    for name in ("half_batch", "slope0", "groupnorm8"):
        with planted(name):
            out[name] = program_readings(cell, "planted_" + name)
        _free()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", choices=("program", "faults", "planted"), required=True)
    p.add_argument("--tables", help="append each run's per-leaf norms (reference, difference) here, as JSON lines")
    args = p.parse_args()
    read = {"program": lambda c: {"program": program_readings(c)}, "faults": fault_readings,
            "planted": planted_readings}[args.what]
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(WORKLOAD, seed, 0.0, False)
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, **read(cell), "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if args.tables:
            with open(args.tables, "a") as f:
                for t in TABLES:
                    f.write(json.dumps({"seed": seed, "first_steps": cell.traffic["first_steps"], **t}) + "\n")
        TABLES.clear()
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
