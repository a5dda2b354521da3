"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with a trace
``breakdown``, and last ``checks``: each number compared with its limit);
the compared numbers are also the last lines of standard error. Without
enough CUDA cards, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not this directory: the port and ``benchmark`` import from it
# every cache the program or the toolchain writes stays in the checkout, at fixed paths
CACHE = ROOT / "build" / "benchmark"
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.lib import harness

    cell = harness.load_cell(args.workload, abs(args.seed), args.seconds, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    out = harness.driver(cell).run(cell)
    setup_s = out.window_start - T0
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    trace = out.readings.trace
    if trace is not None:
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    line = harness.result(cell, out, setup_s, device, harness.manifest())
    for name, value in out.found.items():
        if name not in line["checks"]:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
