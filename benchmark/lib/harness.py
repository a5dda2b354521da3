"""One run of one cell: the manifest read, the driver of the cell's traffic
run, the per-layer readers applied, and the result line built.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), and the limits of its comparison are
``limits/<config>.<traffic>.json``; the mix names its driver
(``drivers/<driver>.py``, one general generator of that kind of traffic),
and each per-layer metric is read by ``metrics/<name>.py``, or where there
is no such file by ``metrics/<stem>.py``, the part of the name before its
first dot. Adding a cell, a configuration, a mix or a metric is adding
files and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark.lib.trace import DeviceTrace, Spans, breakdown

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcmseg_tpu")


@dataclass
class Check:
    """One number of the comparison that decides ``correct``, with its limit:
    it passes when ``value <= limit`` (a NaN never passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Readings:
    """What a traced run leaves for the per-layer readers: the device trace
    of the window, the benchmark's host spans, the program's counters and
    the work the window did, counted from the cell's shapes."""

    window_start_ns: int = 0
    window_end_ns: int = 0
    trace: Optional[DeviceTrace] = None
    spans: Spans = field(default_factory=Spans)
    counters: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9


@dataclass
class Outcome:
    """What a driver reports of one run."""

    attempted: int
    failed: int
    window_start: float  # time.perf_counter() at the first timed step or case
    end_to_end: Dict[str, float]
    readings: Readings
    checks: List[Check]
    memory_peak_bytes: int
    found: Dict[str, float] = field(default_factory=dict)  # every number read, compared or not


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    limits: Dict[str, float] = field(default_factory=dict)  # of each number compared


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, seed: int, seconds: float, trace: bool, root: Path = ROOT) -> Cell:
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config_file = next(c["file"] for c in m["configs"] if c["name"] == entry["config"])
    config = json.loads((root / config_file).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{entry['config']}.{entry['traffic']}.json").read_text())
    return Cell(name, config, traffic, entry["chips"], seed, seconds, trace, limits=limits)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def metric_file(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    ``metrics/<stem>.py`` for a name whose split shares one reader."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    return path if path.is_file() else BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def _metric_reader(name: str) -> Callable[[Readings], Optional[float]]:
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(m: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (those listing it, and those without a
    list whose end-to-end metric it reports)."""
    e2e = [x for x in m["end_to_end"] if cell in x.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if cell in x.get("workloads", [cell] if x["moves"] in names else [])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({k.split(".")[0] for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def result(cell: Cell, out: Outcome, setup_s: float, device: dict, m: dict) -> dict:
    """The result line: ``correct`` and the counts, the cell's metrics, the
    device, with a trace the breakdown, and last the compared numbers."""
    metrics = {}
    for spec in cell_metrics(m, cell.name, cell.trace):
        name = spec["name"]
        if cell.trace:
            value = _metric_reader(name)(out.readings)
        elif name == "setup_s":
            value = setup_s
        else:
            value = out.end_to_end.get(name)
        if value is not None:
            metrics[name] = {"value": _finite(value), "unit": spec["unit"]}
    correct = out.failed == 0 and all(c.ok for c in out.checks)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    if cell.trace and out.readings.trace is not None:
        line["breakdown"] = breakdown(out.readings.trace, out.readings.spans)
    line["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in out.checks}
    return line


def _finite(x: float) -> float:
    """``x`` as strict JSON holds it: an infinite or NaN reading (a request
    that never completed) becomes ±1e300."""
    return x if math.isfinite(x) else (-1e300 if x < 0 else 1e300)
