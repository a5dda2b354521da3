"""A/B of the port's 3³ conv kernels between two checkouts on one NVIDIA GPU.

    python tools/ab_torch_kernels.py PARENT_TREE [CHANGE_TREE]

Runs the kernel phases of each tree's own ``chip_smoke.py`` (B1 forward at
the 14 model shapes, B1 as dx at the 17 transposed shapes, B2 at the 14
shapes, each in bf16 and in fp16, and B1 in bf16 at one of 2 D-slabs' and
one of 2 output-channel shards' shapes: each checked against its plain
version and timed beside it and cuDNN's call, the median of ITERS
launches) in a fresh process per run, in the order parent, change, change,
parent, so that drift on the card falls on both sides. CHANGE_TREE
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
import functools, importlib.util, json, os, sys
ITERS = int(sys.argv[2])
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch
spec = importlib.util.spec_from_file_location("tree_smoke", os.path.join(tree, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from pcmseg_tpu_torch.ops.kernels import build
smoke.median_ms = functools.partial(smoke.median_ms, iters=ITERS)  # the phases look it up at each call
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
seconds = build.build()["seconds"]
card, device = smoke.card_label(), torch.device("cuda")
f16 = torch.float16
runs = {"fwd": smoke.check_kernels(device, card, (1,)), "dx": smoke.check_dx_kernels(device, card),
        "dw": smoke.check_dw_kernels(device, card), "dw16": smoke.check_dw_kernels(device, card, dtype=f16),
        "fwd16": smoke.check_kernels(device, card, (1,), dtype=f16),
        "dx16": smoke.check_dx_kernels(device, card, dtype=f16),
        # one of 2 D-slabs with its halo, one of 2 output-channel shards
        "fwd_slab": smoke.check_kernels(device, card, (1,), slab=True),
        "dx_slab": smoke.check_dx_kernels(device, card, slab=True),
        "fwd_shard": smoke.check_kernels(device, card, (1,), tp=2), "dx_shard": smoke.check_dx_kernels(device, card, tp=2)}
print("AB " + json.dumps({"tree": tree, "build_s": seconds, "card": card, **runs}), flush=True)
"""

# CUDA-event timings a shape (chip_smoke.py's median_ms; its own default is 10)
ITERS = 30


def run(tree: str) -> dict:
    proc = subprocess.Popen([sys.executable, "-c", PHASES, tree, str(ITERS)], cwd=tree, stdout=subprocess.PIPE,
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
    args = sys.argv[1:]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(args[0])
    change = os.path.abspath(args[1] if len(args) == 2 else os.path.join(os.path.dirname(__file__), ".."))
    records = [run(tree) for tree in (parent, change, change, parent)]
    for name, tree in (("parent", parent), ("change", change)):
        sums = {k: [r[k]["ms"] for r in records if r["tree"] == tree] for k in records[0] if isinstance(
            records[0][k], dict)}
        cudnn = {k: [r[k]["library_ms"] for r in records if r["tree"] == tree] for k in sums}
        print(f"{name} {tree}: per 128^3 microbatch, kernel ms {sums}, library ms {cudnn} "
              f"[{records[0]['card']}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
