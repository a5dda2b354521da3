"""A/B of the port's 3³ conv kernels between two checkouts on one NVIDIA GPU.

    python tools/ab_torch_kernels.py PARENT_TREE [CHANGE_TREE]

Runs the kernel phases of each tree's own ``chip_smoke.py`` (B1 forward at
the 14 model shapes, B1 as dx at the 17 transposed shapes, B2 at the 14
shapes in bf16 and in fp16: each checked against its plain version and
timed beside it and cuDNN's call) in a fresh process per run, in the order parent, change,
change, parent, so that drift on the card falls on both sides. CHANGE_TREE
defaults to the checkout this script is in. Each tree builds its kernels
into its own ``build/``. Prints each run's per-layer lines as they come,
one ``AB {...}`` JSON line per run, and a summary of the per-microbatch sums.
Exits non-zero if a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = """
import importlib.util, json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch
spec = importlib.util.spec_from_file_location("tree_smoke", os.path.join(tree, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from pcmseg_tpu_torch.ops.kernels import build
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
seconds = build.build()["seconds"]
card, device = smoke.card_label(), torch.device("cuda")
runs = {"fwd": smoke.check_kernels(device, card, (1,)), "dx": smoke.check_dx_kernels(device, card),
        "dw": smoke.check_dw_kernels(device, card),
        "dw16": smoke.check_dw_kernels(device, card, dtype=torch.float16)}
print("AB " + json.dumps({"tree": tree, "build_s": seconds, "card": card, **runs}), flush=True)
"""


def run(tree: str) -> dict:
    proc = subprocess.Popen([sys.executable, "-c", PHASES, tree], cwd=tree, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    record = None
    for line in proc.stdout:
        print(line, end="", flush=True)
        if line.startswith("AB "):
            record = json.loads(line[3:])
    if proc.wait() != 0 or record is None:
        raise SystemExit(f"the kernel phases of {tree} failed (exit {proc.returncode})")
    return record


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else os.path.join(os.path.dirname(__file__), ".."))
    records = [run(tree) for tree in (parent, change, change, parent)]
    for name, tree in (("parent", parent), ("change", change)):
        sums = {k: [r[k]["ms"] for r in records if r["tree"] == tree] for k in ("fwd", "dx", "dw", "dw16")}
        print(f"{name} {tree}: per 128^3 microbatch, B1 forward {sums['fwd']} ms, B1 as dx {sums['dx']} ms, "
              f"B2 {sums['dw']} ms, fp16 B2 {sums['dw16']} ms [{records[0]['card']}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
