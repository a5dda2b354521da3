"""BENCHMARK.json against the benchmark's contract, and the benchmark's
sources against the import rule: nothing imports JAX, flax or the JAX
package, and the reference imports nothing of the program."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from benchmark.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert list(M) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                               for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) and not w.startswith("/") and ".." not in w
                                           for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file() and c["reduced"] == []
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"]) and w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['config']}.{w['traffic']}.json").is_file()
    assert {c["name"] for c in M["configs"]} == {w["config"] for w in M["workloads"]}
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for x in M["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"} and _line(x["layer"])
        assert x["moves"] in {e["name"] for e in M["end_to_end"]}
        assert harness.metric_file(x["name"]).is_file()
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in M["workloads"]:
        e2e = {x["name"] for x in harness.cell_metrics(M, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(M, w["name"], True)
        assert layer and all(x["moves"] in e2e for x in layer)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), path
    if "reference" in path.parts:
        assert "pcmseg_tpu_torch" not in tops


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pcmseg_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [m for m in harness.FORBIDDEN if m in
                                           {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "pcmseg_tpu.fake", object())
    assert "pcmseg_tpu" in harness.forbidden_modules()


def test_result_line_is_strict_json_and_ends_with_the_checks():
    cell = harness.load_cell("bn_serve_ens5_tta_spaced", 1, 30.0, False)
    out = harness.Outcome(attempted=3, failed=1, window_start=0.0,
                          end_to_end={"serve_p90_ms": float("inf"), "serve_case_s": 1.0},
                          readings=harness.Readings(),
                          checks=[harness.Check("mask_gap", float("nan"), 0.008), harness.Check("missing", 1.0, 0)],
                          memory_peak_bytes=1)
    line = harness.result(cell, out, 12.5, {"platform": "gpu"}, M)
    text = json.dumps(line, allow_nan=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False and set(line["metrics"]) == {"serve_p90_ms", "setup_s"}
    assert json.loads(text)["metrics"]["serve_p90_ms"]["value"] == 1e300
