"""Command line of the PyTorch package: every verb of the JAX package's.

The flags are the JAX package's own (copied into ``cli/parser.py``), so a
command line moves between the two packages unchanged, plus ``--device
{cuda,cpu}`` (default ``cuda``; without a card every verb fails unless
given ``--device cpu``).

    python -m pcmseg_tpu_torch check [--data_dir DATA --save_dir CKPT]
    python -m pcmseg_tpu_torch train --data_dir DATA --save_dir CKPT [--epochs N --cross_validation ...]
    python -m pcmseg_tpu_torch validate --data_dir DATA --model_path 'CKPT/best_fold_*.pth' [--native --tta ...]
    python -m pcmseg_tpu_torch predict --model_path m.pth --input_dir CASE --output_dir OUT
    python -m pcmseg_tpu_torch serve --model_path m.pth --input_root IN --output_dir OUT --once
    python -m pcmseg_tpu_torch export --model_path CKPT/best.pt --output m.pth
    python -m pcmseg_tpu_torch warm-cache --data_dir DATA --cache_dir CACHE

Under torchrun (``WORLD_SIZE`` > 1), ``train`` joins the job's process
group (``parallel.multihost.initialize``: NCCL, or gloo with ``--device
cpu``) and trains data-parallel on ``cuda:LOCAL_RANK``, one card per
process: the counterpart of the JAX CLI training data-parallel over every
local device by default::

    torchrun --nproc_per_node N -m pcmseg_tpu_torch train --data_dir DATA --save_dir CKPT

``train``, ``predict`` and ``serve`` take ``--profile DIR``: a
``torch.profiler`` trace of a few steps, of the prediction, or of the first
served cases, written into DIR as a Chrome / TensorBoard trace.
"""

from __future__ import annotations

import os
import sys
import traceback
from typing import List, Optional

from pcmseg_tpu_torch.cli.parser import _config_from_args, build_parser


def cmd_check(args) -> int:
    from pcmseg_tpu_torch.utils.check import generate_report

    report = generate_report(
        data_dir=args.data_dir, save_dir=args.save_dir, output_path=args.output, device=args.device
    )
    print(f"dependencies ok: {report['dependencies']['ok']}")
    print(f"devices: {report['devices']['device_count']} ({report['devices']['backend']})")
    print(f"data tree ok: {report['data']['ok']}")
    print(f"checkpoints found: {report['checkpoints']['count']}")
    print(f"report written to {args.output}")
    return 0 if report["ok"] else 1


def _join_process_group(device: str):
    """Under torchrun, join the job's process group; returns the device to
    train on (this process's card, or the CPU)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    from pcmseg_tpu_torch.parallel import multihost

    on_cpu = device == "cpu"
    multihost.initialize(backend="gloo" if on_cpu else None)
    multihost.establish_collectives()
    return "cpu" if on_cpu else multihost.local_device()


def cmd_train(args) -> int:
    args.device = _join_process_group(args.device)
    if args.interactive:
        choice = input("select training mode: [1] single-split  [2] cross-validation: ").strip()
        args.cross_validation = choice == "2"
    config = _config_from_args(args, preset=args.preset)
    if getattr(args, "data_augmentation", False):
        config = config.replace(data_augmentation=True)
    if args.cross_validation:
        from pcmseg_tpu_torch.train.cv import CrossValidationTrainer

        results = CrossValidationTrainer(config, device=args.device).train()
        summary = results["summary"]
        print(f"cross-validation: {summary['total_folds']} folds, mean val loss "
              f"{summary['mean_val_loss']:.4f} +- {summary['std_val_loss']:.4f}; "
              f"checkpoints in {config.save_dir}")
        return 0
    from pcmseg_tpu_torch.train.trainer import Trainer

    history = Trainer(config, device=args.device).train()
    print(f"trained {len(history['train_loss'])} epochs; checkpoints in {config.save_dir}")
    return 0


def cmd_validate(args) -> int:
    from pcmseg_tpu_torch.infer.validate import Validator

    config, explicit = _config_from_args(args, with_explicit=True)
    validator = Validator(config, args.model_path, explicit=explicit, device=args.device)
    results = validator.validate_native() if args.native else validator.validate()
    print(
        f"avg_dice={results['avg_dice']:.4f} avg_iou={results['avg_iou']:.4f} "
        f"({results['case_count']} cases)"
    )
    return 0


def cmd_predict(args) -> int:
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.utils.profiling import trace

    config, explicit = _config_from_args(args, with_explicit=True)
    predictor = Predictor(config, args.model_path, explicit=explicit, device=args.device)
    with trace(config.profile_dir, predictor.device):
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
    try:
        if args.once:
            stats = server.run_once()
        else:
            stats = server.run(
                poll_interval=args.poll_interval,
                max_polls=args.max_polls,
                stop_file=args.stop_file,
            )
    finally:
        server.close()  # write a --profile trace whose window is still open
    waiting = f", {stats['waiting']} waiting" if stats.get("waiting") else ""
    print(f"served: {stats['done']} done, {stats['failed']} failed{waiting}")
    if stats["failed"]:
        return 1
    return 2 if stats.get("waiting") else 0


def cmd_export(args) -> int:
    """A training checkpoint (``{save_dir}/{name}.pt``: latest, best,
    epoch_{e}, under any tag) → the reference's ``.pth`` format,
    ``{'model_state_dict': ...}`` with the checkpoint's meta, which the
    reference's validate/predict and this package's load unchanged. With
    EMA on, the averaged weights are exported unless ``--no_ema``."""
    from pcmseg_tpu_torch.infer.predict import resolve_device
    from pcmseg_tpu_torch.train.checkpoints import export_train_checkpoint

    resolve_device(args.device)
    out = export_train_checkpoint(args.model_path, args.output, use_ema=not args.no_ema)
    print(f"exported: {out}")
    return 0


def cmd_warm_cache(args) -> int:
    from pcmseg_tpu_torch.data.warm_cache import warm_cache
    from pcmseg_tpu_torch.infer.predict import resolve_device

    resolve_device(args.device)
    config = _config_from_args(args)
    if not config.cache_dir:
        print("warm-cache requires --cache_dir", file=sys.stderr)
        return 2
    summary = warm_cache(
        config,
        num_threads=args.num_threads,
        process_index=args.process_index,
        process_count=args.process_count,
    )
    print(
        f"warmed {summary['warmed']}, already cached {summary['already_cached']}, "
        f"failed {summary['failed']} ({summary['seconds']}s)"
    )
    return 0 if not summary["failed"] else 1


HANDLERS = {
    "check": cmd_check,
    "train": cmd_train,
    "validate": cmd_validate,
    "predict": cmd_predict,
    "serve": cmd_serve,
    "export": cmd_export,
    "warm-cache": cmd_warm_cache,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return HANDLERS[args.command](args)
    except Exception:  # noqa: BLE001 — top-level trap, like the JAX CLI's
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
