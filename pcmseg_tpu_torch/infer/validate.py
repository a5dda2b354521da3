"""Validator: per-case Dice/IoU over a dataset split → validation_results.json.

The port of ``pcmseg_tpu/infer/validate.py`` for ``.pth`` checkpoints (one,
or several as a fold ensemble), on the GPU unless given ``device="cpu"``:

  * ``validate()`` scores each case at ``target_size``: a single model
    through the eval step with its BatchNorm running statistics (unfolded,
    as the JAX Validator scores it); an ensemble through the folded
    Predictor's averaged probabilities, thresholded (or, K-class, their
    argmax) and scored on the host;
    with ``postprocess`` the masks are component-filtered on the host and
    rescored, so the filter's Dice effect is what is reported. Surface
    metrics (``surface_metrics``) are in voxels there;
  * ``validate_native()`` scores each case at its label's native grid
    through the folded Predictor (tiled where the volume exceeds one
    window), with surface metrics in millimetres;
  * K-class heads (``n_classes >= 2``): each case's ``dice`` and ``iou`` are
    the means over the foreground classes 1..K−1, ``dice_per_class`` holds
    class c's Dice at key ``str(c)``, ``validate()`` adds
    ``avg_dice_per_class``; native labels are read as class ids
    (``clip(rint(label), 0, K−1)``) and the surface metrics score the
    foreground union (``validate.py:225-300, 396-440``);
  * the JSON artifacts and their fields are the JAX package's:
    ``validation_results.json`` and ``validation_results_native.json``;
  * ``spatial_parallel``: the Predictor's paths (the ensemble and
    ``validate_native()``) run its sharded forward (``validate.py:495``);
    the single model's eval step runs in this one process, unsharded.

Also here, used by the
Predictor: the checkpoint config adoption and model loading of ``.pth``
files. Orbax checkpoint directories are the JAX package's format: export
one with ``python run.py export`` to validate it here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu_torch.core.config import PORT_FIELDS, Config
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.data.io import read_volume
from pcmseg_tpu_torch.data.loader import DataLoader, to_device
from pcmseg_tpu_torch.data.resample import normalize_intensity, resample_array
from pcmseg_tpu_torch.infer.postprocess import postprocess_from_config
from pcmseg_tpu_torch.models import build_model
from pcmseg_tpu_torch.models.unet3d import compute_dtype, param_dtype, to_param_dtype
from pcmseg_tpu_torch.ops.metrics import per_class_dice_iou, per_sample_dice_iou
from pcmseg_tpu_torch.ops.surface import case_surface_metrics
from pcmseg_tpu_torch.train.checkpoints import load_pth
from pcmseg_tpu_torch.train.steps import TrainState, make_eval_step
from pcmseg_tpu_torch.utils.artifacts import write_json
from pcmseg_tpu_torch.utils.logging import get_logger

# fields of the checkpoint's config snapshot that must match the weights
# (architecture) or the input distribution they were trained on
_ARCH_KEYS = (
    "model",
    "nnunet_features",
    "n_modalities",
    "n_classes",
    "base_features",
    "norm_layer",
    "group_norm_groups",
    "modalities",
    "ema_decay",
    "deep_supervision",
)
_PREP_KEYS = ("normalize", "norm_percentiles", "target_size")
PTH_EXTS = (".pth", ".pt")

# what ``load_pth`` returns: (state dict, config snapshot or None)
Loaded = Tuple[Dict[str, torch.Tensor], Optional[dict]]


def require_pth(checkpoint_path: str) -> None:
    if not checkpoint_path.endswith(PTH_EXTS):
        raise NotImplementedError(
            f"{checkpoint_path!r}: the PyTorch package reads .pth checkpoints "
            "only; export an Orbax checkpoint with `python run.py export`"
        )


def adopt_checkpoint_config(
    config: Config,
    checkpoint_path: str,
    explicit: Sequence[str] = (),
    loaded: Optional[Loaded] = None,
) -> Config:
    """Adopt the architecture and preprocessing fields of the ``config``
    snapshot in a ``.pth`` payload; keys in ``explicit`` win. Without a
    snapshot (a reference-trained file), ``normalize`` defaults to
    ``'minmax'``, the reference's own inference normalization. ``loaded``
    is the file's ``load_pth`` result where the caller has read it already.
    """
    require_pth(checkpoint_path)
    log = get_logger("pcmseg.validate")
    explicit_set = set(explicit)
    _, snap = loaded or load_pth(checkpoint_path)
    if snap:
        # a snapshot leaves the port's own fields out at their defaults
        snap = {**{f.name: f.default for f in dataclasses.fields(Config) if f.name in PORT_FIELDS}, **snap}
        updates = {}
        for k in _ARCH_KEYS + _PREP_KEYS:
            if k not in snap or k in explicit_set:
                continue
            v = snap[k]
            if isinstance(getattr(config, k), tuple):
                v = tuple(v)
            if v != getattr(config, k):
                updates[k] = v
        if updates:
            log.info("adopting checkpoint config fields: %s", sorted(updates))
            config = config.replace(**updates)
    elif "normalize" not in explicit_set and config.normalize != "minmax":
        log.info(
            "torch checkpoint: defaulting normalize=%r -> 'minmax' to match "
            "the reference's own inference (pass --normalize to override)",
            config.normalize,
        )
        config = config.replace(normalize="minmax")
    return config


def load_model_state(
    config: Config, checkpoint_path: str, loaded: Optional[Loaded] = None
) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(model with the checkpoint's weights on the CPU, its state dict).

    The model is built on the meta device and takes the loaded tensors,
    cast to ``config.param_dtype`` (BatchNorm's running statistics stay
    fp32), as its parameters (a strict load), so nothing is initialised
    twice. ``loaded`` is as in ``adopt_checkpoint_config``.
    """
    require_pth(checkpoint_path)
    state_dict, _ = loaded or load_pth(checkpoint_path)
    state_dict = to_param_dtype(state_dict, param_dtype(config.param_dtype))
    model = build_model(config, device="meta")
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model, state_dict


def _per_class(values) -> Dict[str, float]:
    """Foreground classes' scores keyed by class id (``'1'``..``'K-1'``)."""
    return {str(c + 1): float(v) for c, v in enumerate(values)}


class Validator:
    """Evaluates ``.pth`` checkpoints over a dataset (or an index subset)
    on ``device`` (default: the current CUDA device; without one, pass
    ``device="cpu"``).

    ``checkpoint_path`` may name several checkpoints (a comma-separated
    list, a glob, or a list, as for the Predictor): the fold ensemble's
    averaged probabilities are then scored instead of a single model's.
    """

    def __init__(
        self,
        config: Config,
        checkpoint_path,
        dataset: Optional[ProstateDataset] = None,
        indices: Optional[Sequence[int]] = None,
        explicit: Sequence[str] = (),
        device=None,
    ):
        from pcmseg_tpu_torch.infer.predict import Predictor, expand_model_paths, resolve_device

        paths = expand_model_paths(checkpoint_path)
        require_pth(paths[0])
        loaded = load_pth(paths[0])
        config = adopt_checkpoint_config(config, paths[0], explicit, loaded)
        self.config = config
        self.log = get_logger("pcmseg.validate")
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)
        self.dataset = dataset if dataset is not None else ProstateDataset(
            data_dir=config.data_dir,
            data_type=config.data_type,
            modalities=config.modalities,
            missing_strategy=config.missing_strategy,
            target_size=config.target_size,
            normalize=config.normalize,
            norm_percentiles=config.norm_percentiles,
            cache_dir=config.cache_dir,
            is_training=False,
            n_classes=config.n_classes,
            coregister=config.coregister,
        )
        self.loader = DataLoader(self.dataset, batch_size=config.batch_size, shuffle=False, indices=indices)
        # postprocessing rescores on the host, so it needs the masks there
        self._postprocess = config.postprocess != "none" or config.min_component_voxels > 0
        self._ensemble = None
        if len(paths) > 1:
            self._ensemble = Predictor(config, paths, explicit=explicit, device=self.device)
            return
        model, self._state_dict = load_model_state(config, paths[0], loaded)
        self.model = model.to(self.device).eval()
        # the eval step reads the state for its EMA only: a .pth holds the
        # weights it serves
        self._state = TrainState(model=self.model, optimizer=None)
        self._eval_step = make_eval_step(
            self.model, config, return_pred=config.surface_metrics or self._postprocess
        )

    def _host_rescore(self, masks: np.ndarray, labels) -> tuple:
        """Per-sample (dice, iou, per-class Dice or None) of host uint8
        masks, or K-class label maps (means over the foreground classes)."""
        masks, labels = torch.from_numpy(masks), torch.as_tensor(np.asarray(labels))
        k = int(self.config.n_classes)
        if k >= 2:
            dice_c, iou_c = per_class_dice_iou(masks, labels, k)
            return dice_c.mean(1).tolist(), iou_c.mean(1).tolist(), dice_c.tolist()
        dice, iou = per_sample_dice_iou(masks, labels)
        return dice.tolist(), iou.tolist(), None

    def _batch_scores(self, batch) -> tuple:
        """Per-sample (dice, iou, masks, per-class Dice or None) at
        ``config.threshold`` (the argmax for a K-class head); ``masks`` is
        the uint8 prediction when ``surface_metrics`` asks for it, else
        None."""
        if self._ensemble is None:
            m = self._eval_step(self._state, to_device(batch, self.device, self.dtype))
            masks = m["pred"].cpu().numpy() if "pred" in m else None
            if not self._postprocess:
                dice_class = m["dice_class"].tolist() if "dice_class" in m else None
                return m["dice"].tolist(), m["iou"].tolist(), masks, dice_class
        else:
            probs = self._ensemble.predict_probs_batch(batch["image"])
            if self.config.n_classes >= 2:
                masks = np.argmax(probs, axis=-1).astype(np.uint8)[..., None]
            else:
                masks = (probs > self.config.threshold).astype(np.uint8)
        if self._postprocess:
            masks = np.stack([postprocess_from_config(mk[..., 0], self.config)[..., None] for mk in masks])
        dice, iou, dice_class = self._host_rescore(masks, batch["label"])
        return dice, iou, masks if self.config.surface_metrics else None, dice_class

    def _case_surface(self, mask, label, spacing) -> Dict:
        """Boundary metrics for one case; JSON-safe (inf -> None)."""
        cfg = self.config
        m = case_surface_metrics(
            np.asarray(mask),
            np.asarray(label),
            spacing=spacing,
            percentile=cfg.hausdorff_percentile,
            tolerance=cfg.surface_dice_tolerance,
        )
        return {k: (float(v) if np.isfinite(v) else None) for k, v in m.items()}

    @staticmethod
    def _surface_averages(case_results: List[Dict]) -> Dict:
        """Means over the cases where the metric is defined (one-empty-mask
        cases carry null distances; surface_dice is always defined)."""
        out = {}
        for k in ("hd95", "assd", "surface_dice"):
            vals = [r[k] for r in case_results if r.get(k) is not None]
            out[f"avg_{k}"] = float(np.mean(vals)) if vals else None
        return out

    def _results(self, case_results: List[Dict], native: bool) -> Dict:
        if not case_results:
            raise RuntimeError(f"{'native ' if native else ''}validation ran over zero cases")
        avg_dice = float(np.mean([r["dice"] for r in case_results]))
        avg_iou = float(np.mean([r["iou"] for r in case_results]))
        results = {"timestamp": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")}
        if native:
            results["resolution"] = "native"
        results.update(avg_dice=avg_dice, avg_iou=avg_iou, case_count=len(case_results),
                       case_results=case_results)
        per = [r["dice_per_class"] for r in case_results if "dice_per_class" in r]
        if per and not native:
            results["avg_dice_per_class"] = {c: float(np.mean([p[c] for p in per])) for c in per[0]}
        if self.config.surface_metrics:
            results.update(self._surface_averages(case_results))
            results["surface_units"] = "mm" if native else "voxel"
        self.log.info(
            "%svalidation: avg dice %.4f avg iou %.4f over %d cases",
            "native " if native else "", avg_dice, avg_iou, len(case_results),
        )
        return results

    def validate(self, save: bool = True) -> Dict:
        case_results: List[Dict] = []
        for batch in self.loader:
            dices, ious, masks, dice_class = self._batch_scores(batch)
            for i, (cid, dice, iou) in enumerate(zip(batch["case_id"], dices, ious)):
                rec = {"case_id": cid, "dice": float(dice), "iou": float(iou)}
                if dice_class is not None:
                    rec["dice_per_class"] = _per_class(dice_class[i])
                if masks is not None:
                    # unit spacing: this validator scores on the resampled
                    # target_size grid, so distances read in voxels
                    rec.update(self._case_surface(masks[i], batch["label"][i], (1.0, 1.0, 1.0)))
                case_results.append(rec)
        results = self._results(case_results, native=False)
        if save:
            write_json(os.path.join(self.config.save_dir, "validation_results.json"), results)
        return results

    def validate_native(self, save: bool = True) -> Dict:
        """Per-case Dice/IoU at each label's native grid.

        :meth:`validate` scores volumes resampled to ``target_size``, which
        blurs thin structures in prediction and ground truth alike. Here
        every modality is resampled onto the case's raw label grid, the
        Predictor runs at that resolution (tiled and blended when the
        volume exceeds one window), and the mask is scored against the
        unresampled binarized label, or, K-class, the label map of class
        ids, the surface metrics then scoring the foreground union.
        """
        predictor = self._native_predictor()
        cfg = self.config
        k = int(cfg.n_classes)
        case_results: List[Dict] = []
        for rec in self.dataset.case_list:
            label_vol = read_volume(rec.label_path)
            if k >= 2:
                label = np.clip(np.rint(label_vol.data), 0, k - 1).astype(np.float32)[..., None]
            else:
                label = (label_vol.data > 0).astype(np.float32)[..., None]
            channels = []
            for m in cfg.modalities:
                p = rec.modality_files.get(m)
                if p is None:
                    channels.append(np.zeros(label_vol.shape, np.float32))
                    continue
                data = read_volume(p).data
                if data.shape != label_vol.shape:
                    data = resample_array(data, label_vol.shape, mode="linear")
                channels.append(normalize_intensity(data, cfg.normalize, cfg.norm_percentiles))
            image = np.stack(channels, axis=-1).astype(np.float32)
            mask = predictor.predict_mask(image)[..., None].astype(np.float32)
            dice, iou, dice_class = self._host_rescore(mask[None], label[None])
            case_rec = {"case_id": rec.case_id, "dice": float(dice[0]), "iou": float(iou[0])}
            if dice_class is not None:
                case_rec["dice_per_class"] = _per_class(dice_class[0])
                mask, label = (mask > 0).astype(np.float32), (label > 0).astype(np.float32)
            case_rec["shape"] = list(label_vol.shape)
            if cfg.surface_metrics:
                # Volume spacing is (sx, sy, sz); data axes are (z, y, x):
                # reversed, distances come out in millimetres
                case_rec.update(self._case_surface(mask, label, label_vol.spacing[::-1]))
            case_results.append(case_rec)
        results = self._results(case_results, native=True)
        if save:
            write_json(os.path.join(cfg.save_dir, "validation_results_native.json"), results)
        return results

    def _native_predictor(self):
        """The fold-ensemble Predictor, or a Predictor over this Validator's
        loaded model and weights (no second checkpoint read), built
        through the Predictor's own constructor so that BN folding, TTA,
        tiling and postprocessing are the serving path's."""
        from pcmseg_tpu_torch.infer.predict import Predictor

        if self._ensemble is not None:
            return self._ensemble
        return Predictor(
            self.config.replace(sliding_window=False),
            preloaded=(self.model, self._state_dict),
            device=self.device,
        )
