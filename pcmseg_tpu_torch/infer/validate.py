"""Checkpoint config adoption and model loading for ``.pth`` checkpoints.

The ``.pth`` branches of ``pcmseg_tpu/infer/validate.py``
(``adopt_checkpoint_config``, ``load_model_state``). The Validator itself
is not ported yet. Orbax checkpoint directories are the JAX package's
format: export one with ``python run.py export`` to serve it here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from pcmseg_tpu.core.config import Config
from pcmseg_tpu.utils.logging import get_logger
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train.checkpoints import load_pth

# fields of the checkpoint's config snapshot that must match the weights
# (architecture) or the input distribution they were trained on
_ARCH_KEYS = (
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
) -> Tuple[UNet3D, Dict[str, torch.Tensor]]:
    """(model with the checkpoint's weights on the CPU, its state dict).

    The model is built on the meta device and takes the loaded tensors
    as its parameters (a strict load), so nothing is initialised twice.
    ``loaded`` is as in ``adopt_checkpoint_config``.
    """
    require_pth(checkpoint_path)
    state_dict, _ = loaded or load_pth(checkpoint_path)
    model = UNet3D.from_config(config, device="meta")
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model, state_dict
