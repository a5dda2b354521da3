"""Command line of the PyTorch package: ``train``, ``predict`` and ``serve``.

The flags are the JAX package's own (copied into ``cli/parser.py``), so a
command line moves between the two packages unchanged, plus ``--device
{cuda,cpu}`` (default ``cuda``; without a card the commands fail unless
given ``--device cpu``). The other verbs are not ported yet and exit
non-zero.

    python -m pcmseg_tpu_torch train --data_dir DATA --save_dir CKPT [--epochs N ...]
    python -m pcmseg_tpu_torch predict --model_path m.pth --input_dir CASE --output_dir OUT
    python -m pcmseg_tpu_torch serve --model_path m.pth --input_root IN --output_dir OUT --once
"""

from __future__ import annotations

import os
import sys
import traceback
from typing import List, Optional

from pcmseg_tpu_torch.cli.parser import _config_from_args, build_parser

PORTED = ("train", "predict", "serve")


def cmd_train(args) -> int:
    if args.interactive:
        choice = input("select training mode: [1] single-split  [2] cross-validation: ").strip()
        args.cross_validation = choice == "2"
    if args.cross_validation:
        raise NotImplementedError(
            "--cross_validation is not ported to the PyTorch package yet; "
            "run it with the JAX package: python run.py train --cross_validation"
        )
    from pcmseg_tpu_torch.train.trainer import Trainer

    config = _config_from_args(args, preset=args.preset)
    if getattr(args, "data_augmentation", False):
        config = config.replace(data_augmentation=True)
    history = Trainer(config, device=args.device).train()
    print(f"trained {len(history['train_loss'])} epochs; checkpoints in {config.save_dir}")
    return 0


def cmd_predict(args) -> int:
    from pcmseg_tpu_torch.infer.predict import Predictor

    config, explicit = _config_from_args(args, with_explicit=True)
    predictor = Predictor(config, args.model_path, explicit=explicit, device=args.device)
    out = predictor.predict_and_save(
        args.input_dir,
        os.path.join(args.output_dir, args.output_name),
        threshold=args.threshold,
    )
    print(f"saved: {out}")
    return 0


def cmd_serve(args) -> int:
    from pcmseg_tpu_torch.infer.serve import PredictionServer

    config, explicit = _config_from_args(args, with_explicit=True)
    min_age = args.min_age
    if min_age is None:
        # batch dirs are assumed complete; the upload guard is for watch mode
        min_age = 0.0 if args.once else 30.0
    server = PredictionServer(
        config,
        args.model_path,
        input_root=args.input_root,
        output_dir=args.output_dir,
        output_name=args.output_name,
        explicit=explicit,
        min_age=min_age,
        device=args.device,
    )
    if args.once:
        stats = server.run_once()
    else:
        stats = server.run(
            poll_interval=args.poll_interval,
            max_polls=args.max_polls,
            stop_file=args.stop_file,
        )
    waiting = f", {stats['waiting']} waiting" if stats.get("waiting") else ""
    print(f"served: {stats['done']} done, {stats['failed']} failed{waiting}")
    if stats["failed"]:
        return 1
    return 2 if stats.get("waiting") else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command not in PORTED:
        print(
            f"'{args.command}' is not yet ported to the PyTorch package "
            f"(ported: {', '.join(PORTED)}); run it with the JAX package: "
            f"python run.py {args.command}",
            file=sys.stderr,
        )
        return 1
    handlers = {"train": cmd_train, "predict": cmd_predict, "serve": cmd_serve}
    try:
        return handlers[args.command](args)
    except Exception:  # noqa: BLE001 — top-level trap, like the JAX CLI's
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
