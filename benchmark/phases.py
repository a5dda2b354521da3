"""Where a traced window's device time and idle gaps sit by the program's
own phases, for one run of one cell:

    python3 benchmark/phases.py --workload NAME --seed N --seconds S [--out FILE]

The cell runs as under ``run.py --trace 1`` (the same driver, profiler and
window); besides, each device operation's launch is kept from the
profile, and every operation and idle gap is put down to the program span
(``pcmseg_tpu_torch/utils/profiling.py``) open where it was launched or
began (``lib/program_spans.py``). Prints one JSON line, also appended to
``--out``: the end-to-end metrics of the traced window, the run's result
line, the program's spans (counts, dropped), device milliseconds a step
or a case by span and how each operation's span was found, idle seconds by
program span, the host's calls that can wait for the card by span, the top operations by span
and, in a serving cell, the window's totals of the serving spans and each
case's dispatch with and without a decode running beside it. Against a
program that records no spans, only the first two."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
from collections import defaultdict  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if not __package__:  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import benchmark.run  # noqa: E402,F401  (the run's environment: every cache inside the checkout)
from benchmark.lib import harness, program_spans, stats  # noqa: E402
from benchmark.lib.trace import DeviceTrace, short_name  # noqa: E402

SERVING = ("serve.prefetch_wait", "serve.poll", "serve.dispatch", "serve.fetch", "serve.postprocess", "serve.write",
           "serve.decode")


def _overlap_ms(a, spans) -> float:
    return sum(max(0, min(a.end_ns, s.end_ns) - max(a.start_ns, s.start_ns)) for s in spans) / 1e6


def serving(spans, window) -> dict:
    """The window's totals of the serving spans (s), and each case's
    dispatch (ms) split by whether a ``serve.decode`` ran beside it, with
    the least-squares slope of its milliseconds on the milliseconds of
    decode beside it."""
    inside = [s for s in spans if window[0] <= s.end_ns <= window[1]]
    totals = {n: sum(s.end_ns - s.start_ns for s in inside if s.name == n) / 1e9 for n in SERVING}
    decodes = [s for s in spans if s.name == "serve.decode"]
    dispatch = {}
    for s in inside:
        if s.name == "serve.dispatch":
            dispatch.setdefault(s.key, []).append(s)
    rows = [(sum(s.end_ns - s.start_ns for s in ss) / 1e6, sum(_overlap_ms(s, decodes) for s in ss))
            for ss in dispatch.values()]
    split = {"with_decode": [ms for ms, ov in rows if ov > 0], "alone": [ms for ms, ov in rows if ov == 0]}
    n = len(rows)
    mx, my = (sum(ov for _, ov in rows) / n, sum(ms for ms, _ in rows) / n) if n else (0.0, 0.0)
    sxx = sum((ov - mx) ** 2 for _, ov in rows)
    slope = sum((ov - mx) * (ms - my) for ms, ov in rows) / sxx if sxx else None
    return {"totals_s": totals, "cases": len(program_spans.keys_of(inside, "serve.case")),
            "dispatch_ms": {k: {"n": len(v), "median": stats.median(v), "mean": sum(v) / len(v) if v else None}
                            for k, v in split.items()},
            "decode_beside_dispatch_ms": mx, "dispatch_ms_per_decode_ms": slope}


def host_waits(waits, records, units) -> dict:
    """By program span: the host's ms a step or case in calls that can wait
    for the card, the calls a step or case, and the longest call's ms."""
    out = defaultdict(lambda: {"ms_per_unit": 0.0, "calls_per_unit": 0.0, "longest_ms": 0.0})
    for (a, b, _, _), name in zip(waits, program_spans.wait_spans(waits, records)):
        w = out[name]
        w["ms_per_unit"] += (b - a) / 1e6 / units
        w["calls_per_unit"] += 1 / units
        w["longest_ms"] = max(w["longest_ms"], (b - a) / 1e6)
    return dict(out)


def phases(out, activity, drained) -> dict:
    r, tr = out.readings, out.readings.trace
    records = drained.records
    window = (r.window_start_ns, r.window_end_ns)
    counts, host_s = defaultdict(int), defaultdict(float)
    for s in records:
        if window[0] <= s.end_ns <= window[1]:
            counts[s.name] += 1
            host_s[s.name] += (s.end_ns - s.start_ns) / 1e9
    units = r.counters.get("steps") or counts.get("serve.case") or 1
    pacing = next((s.thread for s in records if s.name in ("train.step", "serve.case")), None)
    att = program_spans.attribute(activity, records)
    device = att.device_s(tr.start_ns, tr.end_ns)
    rules = att.device_s_by_rule(tr.start_ns, tr.end_ns)
    result = {
        "spans": dict(counts), "dropped": drained.dropped, "units": units,
        "device_ms_per_unit": {k: 1e3 * v / units for k, v in sorted(device.items(), key=lambda kv: -kv[1])},
        "device_ms_per_unit_total": 1e3 * sum(device.values()) / units,
        "trace_device_ms_per_unit": 1e3 * tr.total_s() / units,
        "device_s_by_rule": rules,
        "launches_matched": sum(op.correlation in activity.launches for op in activity.ops),
        "ops": len(activity.ops),
        "idle_s_by_program_span": program_spans.idle_by_span(tr.idle_gaps(), records, pacing),
        "host_waits": host_waits(activity.waits, records, units),
        "top_ops": {k: [[short_name(n, 72), s] for n, s in v] for k, v in att.top_ops(tr.start_ns, tr.end_ns).items()},
        "host_ms_per_unit": {k: 1e3 * v / units for k, v in host_s.items()},
    }
    if "serve.case" in counts:
        result["serving"] = serving(records, window)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    cell = harness.load_cell(args.workload, abs(args.seed), args.seconds, True)
    import torch

    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    kept = {}
    from_profiler = DeviceTrace.from_profiler.__func__

    def keeping(cls, prof, start_ns, end_ns):
        kept["activity"] = program_spans.DeviceActivity.from_events(prof.profiler.kineto_results.events())
        return from_profiler(cls, prof, start_ns, end_ns)

    DeviceTrace.from_profiler = classmethod(keeping)
    out = harness.driver(cell).run(cell)
    trace = out.readings.trace
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes, "busy_s": trace.busy_s(), "window_s": trace.window_s}
    line = harness.result(cell, out, out.window_start - T0, device, harness.manifest())  # drains the program's spans
    report = {"workload": cell.name, "seed": cell.seed, "end_to_end": out.end_to_end, "line": line}
    drained = getattr(out.readings, "program_spans", None)
    if drained is not None:
        report["phases"] = phases(out, kept["activity"], drained)
    text = json.dumps(report, allow_nan=False, default=str)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
