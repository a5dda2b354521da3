"""The command-line flags: a copy of the parser half of the JAX package's
``pcmseg_tpu/cli/main.py`` (``build_parser`` and ``_config_from_args``), so
a command line moves between the two packages unchanged.

The additions are ``--device {cuda,cpu}`` on every verb, the counterpart
of ``JAX_PLATFORMS=cpu`` (``_config_from_args`` does not read it; the CLI
hands it to the Trainer, CrossValidationTrainer, Validator, Predictor,
PredictionServer and the environment check), and the port's own config
fields (``core/config.py`` ``PORT_FIELDS``): ``--model`` on every verb that
builds a network, ``--optimizer`` on ``train``. A command
line without them moves between the two packages unchanged.
"""

from __future__ import annotations

import argparse

from pcmseg_tpu_torch.core.config import PRESETS, get_config


def _add_postprocess_flags(p: argparse.ArgumentParser) -> None:
    # connected-component mask filtering (infer/postprocess.py); on
    # validate the filtered masks are what gets scored, so the filter's
    # Dice effect is measurable before it's turned on in serving
    p.add_argument("--device_ingest", action="store_true", default=None,
                   help="normalize+cast+stack each case's modalities ON "
                        "the device (raw upload in each volume's own "
                        "dtype, int16 at 2 B/voxel) instead of the host "
                        "C++ pass; the host then only decodes")
    p.add_argument("--postprocess", choices=["none", "largest_cc"],
                   default=None,
                   help="filter thresholded masks: largest_cc keeps only "
                        "the largest foreground component (nnU-Net-style)")
    p.add_argument("--min_component_voxels", type=int, default=None,
                   help="drop mask components smaller than this many "
                        "voxels (0 disables; composes with --postprocess)")


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_dir", default="data", help="data root directory")
    p.add_argument("--data_type", choices=["BPH", "PCA"], default="BPH")
    p.add_argument(
        "--missing_strategy",
        choices=["zero_fill", "skip", "duplicate"],
        default=None,
    )
    p.add_argument("--target_size", type=int, nargs=3, default=None,
                   metavar=("D", "H", "W"))
    p.add_argument("--base_features", type=int, default=None)
    p.add_argument("--n_classes", type=int, default=None,
                   help="1 (default): sigmoid binary segmentation. K >= 2: "
                        "K-class softmax — integer label maps (values "
                        "0..K-1) train with per-class Dice/CE "
                        "(ops/losses.py), validate reports per-class Dice, "
                        "and predict writes the argmax label map")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--coregister", action="store_true", default=None,
                   help="resample every modality (and the label) onto the "
                        "anchor modality's grid by PHYSICAL coordinates "
                        "before the target_size resize — needed when "
                        "ADC/DWI/T2 acquisition grids differ (the "
                        "reference stacks index-space arrays and assumes "
                        "aligned grids)")
    p.add_argument("--normalize",
                   choices=["percentile", "minmax", "zscore", "none"],
                   default=None)
    p.add_argument("--cache_dir", default=None)
    p.add_argument(
        "--device_cache_gb", type=float, default=None,
        help="HBM budget for the device-resident dataset cache "
             "(0 disables; default 4.0 — see BENCH.md)",
    )
    p.add_argument(
        "--async_checkpoint", action="store_true", default=None,
        help="overlap checkpoint writes with the next epoch: a writer "
             "thread saves a snapshot of the state held in pinned host "
             "memory (two snapshots at most, ~1.1 GB each for the "
             "base-64 model)",
    )
    p.add_argument(
        "--remat", type=int, choices=[0, 1], default=None,
        help="rematerialize DoubleConv blocks (memory for compute)",
    )
    p.add_argument("--norm_layer", choices=["batch", "group"], default=None)
    p.add_argument("--model", choices=["unet3d", "nnunet"], default=None,
                   help="the network: the reference's 4-level U-Net "
                        "(default) or nnU-Net's 3d_fullres PlainConvUNet "
                        "(InstanceNorm, LeakyReLU, strided downsampling)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pcmseg",
        description="TPU-native multimodal prostate MRI segmentation",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    # check
    pc = sub.add_parser("check", help="environment / data / checkpoint report")
    pc.add_argument("--data_dir", default="data")
    pc.add_argument("--save_dir", default="checkpoints")
    pc.add_argument("--output", default="project_check_report.json")

    # train
    pt = sub.add_parser("train", help="train a model")
    _add_common_flags(pt)
    pt.add_argument("--preset", choices=sorted(PRESETS), default="standard")
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--learning_rate", type=float, default=None)
    pt.add_argument("--optimizer", choices=["adam", "sgd"], default=None,
                    help="Adam with coupled L2 (default), or Nesterov SGD "
                         "(momentum 0.99, coupled weight decay): nnU-Net's "
                         "optimizer")
    pt.add_argument("--cross_validation", action="store_true",
                    help="K-fold cross-validation training")
    pt.add_argument("--n_splits", type=int, default=None)
    pt.add_argument("--optimized", action="store_true",
                    help="accepted for reference-CLI compatibility; the "
                         "jit/bf16 path is always on")
    pt.add_argument("--no_validation", action="store_true")
    pt.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in save_dir")
    pt.add_argument(
        "--loss",
        choices=["dice", "bce_dice", "tversky", "focal", "focal_dice"],
        default=None,
    )
    pt.add_argument("--data_augmentation", action="store_true")
    pt.add_argument("--aug_scale", type=float, default=None, metavar="S",
                    help="with --data_augmentation: random isotropic zoom "
                         "U(1-S, 1+S) (nnU-Net-style; try 0.15)")
    pt.add_argument("--aug_rotate_deg", type=float, default=None, metavar="R",
                    help="with --data_augmentation: random H-W-plane "
                         "rotation U(-R, R) degrees (try 20)")
    pt.add_argument("--aug_gamma", type=float, default=None, metavar="G",
                    help="with --data_augmentation: intensity gamma "
                         "exp(U(-G, G)) on the normalized range (try 0.3)")
    pt.add_argument("--aug_noise", type=float, default=None, metavar="N",
                    help="with --data_augmentation: additive Gaussian "
                         "noise, sigma U(0, N)·std (try 0.1)")
    pt.add_argument("--aug_blur_prob", type=float, default=None, metavar="P",
                    help="with --data_augmentation: Gaussian blur "
                         "(sigma 0.5-1.1 vox) with probability P (try 0.2)")
    pt.add_argument("--scheduler",
                    choices=["reduce_on_plateau", "cosine", "poly",
                             "constant"],
                    default=None,
                    help="LR schedule: the reference's plateau (default), "
                         "cosine annealing, nnU-Net-style poly decay, or "
                         "constant")
    pt.add_argument("--warmup_epochs", type=int, default=None,
                    help="linear LR ramp over the first N epochs "
                         "(works with every --scheduler)")
    pt.add_argument("--ema_decay", type=float, default=None,
                    help="EMA (Polyak) weight averaging: keep an "
                         "exponential moving average of the weights "
                         "(e.g. 0.999) updated inside the train step; "
                         "validation, 'best' selection, and serving use "
                         "the averaged weights. 0 (default) disables")
    pt.add_argument("--train_crop", type=int, nargs=3, default=None,
                    metavar=("D", "H", "W"),
                    help="train on random crops of this size from the "
                         "target_size volumes (nnU-Net-style patch "
                         "sampling; ~(crop/target)^3 lighter steps). "
                         "Validation and serving stay full-size")
    pt.add_argument("--oversample_fg", type=float, default=None,
                    metavar="P",
                    help="probability that a --train_crop patch is forced "
                         "to contain a foreground voxel (nnU-Net uses "
                         "0.33; uniform crops mostly miss small lesions). "
                         "Default 0 = uniform crops")
    pt.add_argument("--oversample_mode", choices=("center", "window"),
                    default=None,
                    help="forced-patch placement: 'center' = nnU-Net "
                         "(deterministic per-batch fraction, crop centered "
                         "on a foreground voxel; default), 'window' = "
                         "per-sample Bernoulli, voxel anywhere in window")
    pt.add_argument("--deep_supervision", action="store_true",
                    help="nnU-Net-style deep supervision: auxiliary "
                         "1x1x1 heads on the 1/2, 1/4, 1/8 decoder levels, "
                         "loss applied at every scale (geometric weights). "
                         "Inference speed is unchanged")
    pt.add_argument("--interactive", action="store_true",
                    help="prompt for training mode (reference "
                         "train_bph_optimized.py:509-522 parity shim)")
    pt.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome / "
                         "TensorBoard *.pt.trace.json) of --profile_steps "
                         "training steps, from the second on, into DIR")
    pt.add_argument("--profile_steps", type=int, default=None)

    # validate
    pv = sub.add_parser("validate", help="evaluate a checkpoint (Dice/IoU)")
    _add_common_flags(pv)
    pv.add_argument("--model_path", required=True,
                    help="checkpoint dir (Orbax) or torch .pth; several "
                         "(comma-separated or a glob like "
                         "'run/best_fold_*') score the fold ensemble's "
                         "averaged probabilities")
    pv.add_argument("--native", action="store_true",
                    help="score at each label's native grid via "
                         "sliding-window inference (the honest Dice; "
                         "default scores on target_size-resampled volumes "
                         "like the reference)")
    pv.add_argument("--tta", action="store_true",
                    help="8-way flip-ensemble test-time augmentation "
                         "(with --native)")
    pv.add_argument("--surface_metrics", action="store_true",
                    help="also report boundary metrics per case: robust "
                         "Hausdorff (HD95), average symmetric surface "
                         "distance, and normalized surface Dice. Units are "
                         "voxels on the default resampled grid, "
                         "millimetres with --native")
    pv.add_argument("--surface_tolerance", type=float, default=None,
                    help="normalized-surface-Dice tolerance "
                         "(voxels, or mm with --native; default 1.0)")
    pv.add_argument("--hausdorff_percentile", type=float, default=None,
                    help="robust-Hausdorff percentile (default 95; "
                         "100 = classical Hausdorff)")
    pv.add_argument("--no_ema", action="store_true",
                    help="score the live (non-averaged) weights of an "
                         "EMA-trained checkpoint")
    _add_postprocess_flags(pv)

    # predict
    pp = sub.add_parser("predict", help="segment a case directory")
    _add_common_flags(pp)
    pp.add_argument("--model_path", required=True,
                    help="checkpoint to serve; several (comma-separated or "
                         "a glob like 'run/best_fold_*') serve a "
                         "cross-validation fold ensemble — probabilities "
                         "are averaged in one compiled program")
    pp.add_argument("--input_dir", required=True,
                    help="case dir with one subdir per modality")
    pp.add_argument("--output_dir", default="predictions")
    pp.add_argument("--output_name", default="segmentation.nii.gz")
    pp.add_argument("--threshold", type=float, default=None)
    pp.add_argument("--sliding_window", action="store_true")
    pp.add_argument("--window_size", type=int, nargs=3, default=None)
    pp.add_argument("--window_overlap", type=float, default=None)
    pp.add_argument("--window_blend", choices=["gaussian", "uniform"],
                    default=None)
    pp.add_argument("--tta", action="store_true",
                    help="8-way flip-ensemble test-time augmentation at 8x "
                         "serving compute. Measured (BENCH.md): large gains "
                         "on weak models (held-out mean 0.175 -> 0.365), "
                         "fractions of a Dice point on converged ones "
                         "(+0.000-0.002) — use when chasing the last "
                         "margin, not in routine serving")
    pp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome / "
                         "TensorBoard *.pt.trace.json) of the prediction "
                         "into DIR")
    pp.add_argument("--no_ema", action="store_true",
                    help="serve the live (non-averaged) weights of an "
                         "EMA-trained checkpoint")
    _add_postprocess_flags(pp)

    # serve: resident predictor over a directory of cases
    ps = sub.add_parser(
        "serve",
        help="long-running predictor: segment cases as they appear",
    )
    _add_common_flags(ps)
    ps.add_argument("--model_path", required=True,
                    help="checkpoint to serve; several (comma-separated or "
                         "a glob like 'run/best_fold_*') serve a "
                         "cross-validation fold ensemble")
    ps.add_argument("--input_root", required=True,
                    help="root dir; each subdir is one case (per-modality "
                         "subdirs inside)")
    ps.add_argument("--output_dir", default="predictions")
    ps.add_argument("--output_name", default="segmentation.nii.gz")
    ps.add_argument("--once", action="store_true",
                    help="process pending cases once and exit")
    ps.add_argument("--poll_interval", type=float, default=5.0)
    ps.add_argument("--max_polls", type=int, default=None)
    ps.add_argument("--stop_file", default=None,
                    help="exit when this file appears")
    ps.add_argument("--min_age", type=float, default=None,
                    help="serve a case only after its files have been "
                         "quiescent this many seconds (guards against "
                         "serving mid-upload; 0 disables). Default: 30 in "
                         "watch mode, 0 with --once (batch dirs are "
                         "assumed complete)")
    ps.add_argument("--sliding_window", action="store_true")
    ps.add_argument("--window_size", type=int, nargs=3, default=None)
    ps.add_argument("--window_overlap", type=float, default=None)
    ps.add_argument("--window_blend", choices=["gaussian", "uniform"],
                    default=None)
    ps.add_argument("--threshold", type=float, default=None)
    ps.add_argument("--tta", action="store_true",
                    help="8-way flip-ensemble test-time augmentation (8x "
                         "compute; see predict --help for when it pays)")
    ps.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome / "
                         "TensorBoard *.pt.trace.json) of the first "
                         "--profile_steps served cases into DIR")
    ps.add_argument("--profile_steps", type=int, default=None,
                    help="number of cases the serve trace covers "
                         "(default: config.profile_steps)")
    ps.add_argument("--no_ema", action="store_true",
                    help="serve the live (non-averaged) weights of an "
                         "EMA-trained checkpoint")
    _add_postprocess_flags(ps)

    # export: our checkpoint → reference-compatible torch .pth
    pe = sub.add_parser(
        "export",
        help="export a checkpoint to a reference-compatible torch .pth",
    )
    _add_common_flags(pe)
    pe.add_argument("--model_path", required=True,
                    help="checkpoint dir (Orbax) to export")
    pe.add_argument("--output", required=True,
                    help="destination .pth path ({'model_state_dict': ...},"
                         " loadable by the reference's validate/predict)")
    pe.add_argument("--no_ema", action="store_true",
                    help="export the live (non-averaged) weights of an "
                         "EMA-trained checkpoint")

    # warm-cache: populate the preprocessing cache up front
    pw = sub.add_parser(
        "warm-cache",
        help="decode+resample every case once into the .npz cache",
    )
    _add_common_flags(pw)
    pw.add_argument("--num_threads", type=int, default=4)
    pw.add_argument("--process_index", type=int, default=0,
                    help="this host's shard index (multi-host warming)")
    pw.add_argument("--process_count", type=int, default=1)

    for verb in (pc, pt, pv, pp, ps, pe, pw):
        verb.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                          help="the device (default cuda, which fails without "
                               "a card; cpu runs the kernels' plain versions)")
    return parser


def _config_from_args(args, preset: str = "standard", with_explicit: bool = False):
    """Build a Config from preset + the non-None CLI overrides.

    With ``with_explicit`` returns ``(config, explicit_keys)`` where
    ``explicit_keys`` are the Config fields the user actually set — these
    win over a checkpoint's meta.json snapshot in validate/predict.
    """
    mapping = {
        "data_dir": "data_dir",
        "data_type": "data_type",
        "missing_strategy": "missing_strategy",
        "base_features": "base_features",
        "n_classes": "n_classes",
        "batch_size": "batch_size",
        "save_dir": "save_dir",
        "seed": "seed",
        "normalize": "normalize",
        "coregister": "coregister",
        "cache_dir": "cache_dir",
        "device_cache_gb": "device_data_cache_gb",
        "async_checkpoint": "async_checkpoint",
        "remat": "remat",
        "norm_layer": "norm_layer",
        "model": "model",
        "optimizer": "optimizer",
        "epochs": "num_epochs",
        "learning_rate": "learning_rate",
        "n_splits": "n_splits",
        "loss": "loss",
        "scheduler": "scheduler",
        "warmup_epochs": "warmup_epochs",
        "ema_decay": "ema_decay",
        "aug_scale": "aug_scale",
        "aug_rotate_deg": "aug_rotate_deg",
        "aug_gamma": "aug_gamma",
        "aug_noise": "aug_noise",
        "aug_blur_prob": "aug_blur_prob",
        "oversample_fg": "oversample_fg",
        "oversample_mode": "oversample_mode",
        "threshold": "threshold",
        "surface_tolerance": "surface_dice_tolerance",
        "hausdorff_percentile": "hausdorff_percentile",
        "window_overlap": "window_overlap",
        "window_blend": "window_blend",
        "profile": "profile_dir",
        "profile_steps": "profile_steps",
        "postprocess": "postprocess",
        "min_component_voxels": "min_component_voxels",
        "device_ingest": "device_ingest",
    }
    overrides = {}
    for arg_name, cfg_name in mapping.items():
        v = getattr(args, arg_name, None)
        if v is not None:
            overrides[cfg_name] = v
    if "remat" in overrides:  # --remat {0,1} → bool
        overrides["remat"] = bool(overrides["remat"])
    if getattr(args, "target_size", None) is not None:
        overrides["target_size"] = tuple(args.target_size)
    if getattr(args, "window_size", None) is not None:
        overrides["window_size"] = tuple(args.window_size)
    if getattr(args, "train_crop", None) is not None:
        overrides["train_crop"] = tuple(args.train_crop)
    if getattr(args, "no_validation", False):
        overrides["validation"] = False
    if getattr(args, "resume", False):
        overrides["resume"] = True
    if getattr(args, "sliding_window", False):
        overrides["sliding_window"] = True
    if getattr(args, "tta", False):
        overrides["tta"] = True
    if getattr(args, "surface_metrics", False):
        overrides["surface_metrics"] = True
    if getattr(args, "no_ema", False):
        overrides["ema_eval"] = False
    if getattr(args, "deep_supervision", False):
        overrides["deep_supervision"] = True
    config = get_config(preset, **overrides)
    if with_explicit:
        return config, frozenset(overrides)
    return config
