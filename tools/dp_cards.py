#!/usr/bin/env python3
"""Data-parallel training of pcmseg_tpu_torch over the cards of one host,
one process a card in an NCCL group:

    python3 tools/dp_cards.py [--cards N]      (default: every card; N divides 4)

Runs ``chip_smoke.py``'s data-parallel checks with N NCCL ranks instead of
two gloo ranks sharing one card:

  1. 3 flagship steps (base 64, 128³, batch 4 as 4 microbatches of 1, bf16,
     Dice, Adam 1e-4) from the same seeded weights and batches, each rank
     running 4 / N whole microbatches, against the same steps in one
     process on card 0: ranks bitwise equal, the first loss and the running
     statistics after it bitwise equal to one process's, parameters within
     2·lr a step, exact B1 / B2 launches a rank; each rank's step time and
     its NCCL gradient all-reduce (361.2 MB of fp32) beside the
     one-process step;
  2. a 2-epoch flagship Trainer over 12 synthetic 128³ cases from the
     device cache sharded over the ranks, with asynchronous checkpoints:
     histories bitwise equal across the ranks and within 1e-3 of the same
     run in one process, exact launches, each run's ``train()`` seconds.

Prints the cards' names and power limits; exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dp_cards: no CUDA device", file=sys.stderr)
        return 1
    n = args.cards or torch.cuda.device_count()
    if n > torch.cuda.device_count() or n < 1 or smoke.TRAIN["accum_steps"] % n:
        print(f"dp_cards: {n} cards of {torch.cuda.device_count()}; the count must divide "
              f"{smoke.TRAIN['accum_steps']}", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = f"{n} x {cards[0]}" if len(set(cards[:n])) == 1 else "; ".join(cards[:n])
    smoke.log(f"dp_cards: {n} of {len(cards)} cards: {cards} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    from pcmseg_tpu_torch.ops.kernels import build

    info = build.build()
    smoke.log(f"build: {'cached' if info['cached'] else 'compiled'} in {info['seconds']:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(REPO, "build", "dp_cards")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ref = smoke.dp_reference(torch.device("cuda", 0))
    smoke.dp_steps(work, ref, n, "nccl", card, f"dp {n} cards")
    smoke.dp_trainers(work, n, "nccl", card, f"dp {n} cards")
    shutil.rmtree(work, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
