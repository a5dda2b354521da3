"""Reference-layout ``.pth`` checkpoints, the JAX-parameter bridge, and the
trainer's checkpoints.

The port's state dict is the reference PyTorch model's (module names in
``models/unet3d.py``), so the ``.pth`` files that
``pcmseg_tpu.train.checkpoints.export_torch_checkpoint`` writes load here
unchanged: ``{'model_state_dict': ..., 'config': {...}}``, or a bare state
dict.

Weight layouts:
  * JAX conv kernel (kD, kH, kW, I, O) ↔ ``.pth`` conv weight (O, I, kD, kH, kW);
  * JAX transposed-conv kernel (kD, kH, kW, I, O), stored spatially flipped
    (``pcmseg_tpu/train/checkpoints.py:335-339``) ↔ ``.pth`` (I, O, kD, kH, kW);
  * BN scale/bias/mean/var ↔ weight/bias/running_mean/running_var;
    GroupNorm scale/bias ↔ weight/bias (no running statistics);
  * a K-class head's ``outc`` (and ``ds{i}``) has K outputs.
The conv kernel's own packed layout is built from the ``.pth`` layout at
run time (``ops/kernels/conv3d.py::pack_weight``).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


_DS_HEAD = re.compile(r"ds\d+\.")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


def _conv_weight(kernel) -> torch.Tensor:
    # (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)
    return _tensor(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _conv_transpose_weight(kernel) -> torch.Tensor:
    # undo the JAX side's spatial flip, then (kD, kH, kW, I, O) -> (I, O, kD, kH, kW)
    a = np.asarray(kernel)[::-1, ::-1, ::-1]
    return _tensor(np.transpose(a, (3, 4, 0, 1, 2)))


def state_dict_from_jax_params(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's params as numpy trees.

    Mirrors ``pcmseg_tpu.train.checkpoints.params_to_torch_state_dict``
    without importing JAX. BN-folded trees (no ``norm{i}`` entries) give a
    state dict for ``UNet3D(norm_layer='none')``; GroupNorm trees (``norm{i}``
    without batch statistics) one for ``UNet3D(norm_layer='group')``. A deep-supervision tree's
    aux heads ``ds{i}``, which that exporter leaves out, become ``ds{i}.weight``
    and ``ds{i}.bias`` of ``UNet3D(deep_supervision=True)``.
    """
    batch_stats = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}

    def double_conv(prefix: str, ours: Mapping, stats: Optional[Mapping]) -> None:
        for ti, (cname, nname) in ((0, ("conv0", "norm0")), (3, ("conv1", "norm1"))):
            sd[f"{prefix}.{ti}.weight"] = _conv_weight(ours[cname]["kernel"])
            sd[f"{prefix}.{ti}.bias"] = _tensor(ours[cname]["bias"])
            if nname not in ours:
                continue
            sd[f"{prefix}.{ti + 1}.weight"] = _tensor(ours[nname]["scale"])
            sd[f"{prefix}.{ti + 1}.bias"] = _tensor(ours[nname]["bias"])
            if stats and nname in stats:
                sd[f"{prefix}.{ti + 1}.running_mean"] = _tensor(stats[nname]["mean"])
                sd[f"{prefix}.{ti + 1}.running_var"] = _tensor(stats[nname]["var"])
                sd[f"{prefix}.{ti + 1}.num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.int64
                )

    double_conv("inc.conv", params["inc"], batch_stats.get("inc"))
    for i in range(1, 5):
        double_conv(
            f"down{i}.maxpool_conv.1.conv",
            params[f"down{i}"]["double_conv"],
            (batch_stats.get(f"down{i}") or {}).get("double_conv"),
        )
    for i in range(1, 5):
        up = params[f"up{i}"]
        sd[f"up{i}.up.weight"] = _conv_transpose_weight(up["up"]["kernel"])
        sd[f"up{i}.up.bias"] = _tensor(up["up"]["bias"])
        double_conv(
            f"up{i}.conv.conv",
            up["double_conv"],
            (batch_stats.get(f"up{i}") or {}).get("double_conv"),
        )
    for name in ["outc"] + [f"ds{i}" for i in range(1, 4) if f"ds{i}" in params]:
        sd[f"{name}.weight"] = _conv_weight(params[name]["kernel"])
        sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    return sd


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """(state dict, config snapshot or None) from a reference-layout .pth.

    Loads with ``weights_only=True``: tensors and plain containers only.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint dict")
    if "model_state_dict" in payload:
        return dict(payload["model_state_dict"]), payload.get("config") or None
    return dict(payload), None


def save_pth(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config: Optional[dict] = None,
    meta: Optional[dict] = None,
) -> str:
    """Write ``{'model_state_dict': ..., 'config': ...}`` atomically; the
    ``meta`` entries go beside them, as ``export_torch_checkpoint`` writes
    its meta."""
    payload = {"model_state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    payload.update(meta or {})
    if config:
        payload["config"] = config
    return _atomic_write(path, lambda tmp: torch.save(payload, tmp))


def _atomic_write(path: str, write) -> str:
    """``write(tmp)`` to a temporary name beside ``path``, then ``os.replace``
    it into place, so an interrupted write leaves the previous file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path), f".tmp-{os.getpid()}-{os.path.basename(path)}")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


# ---- training checkpoints ----------------------------------------------------
#
# The Orbax half of ``pcmseg_tpu/train/checkpoints.py``: one file per name
# (``latest``, ``best``, ``epoch_{e}``) holding the model state dict (BN
# running statistics included), the optimizer state, the EMA, the step count
# and the trainer's meta (epoch, history, best monitor, scheduler and early
# stopping), written with ``torch.save`` to a temporary name and moved into
# place with ``os.replace``, so an interrupted save leaves the previous file.

TRAIN_SUFFIX = ".pt"


def train_checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(directory)), name + TRAIN_SUFFIX)


def save_train_checkpoint(directory: str, name: str, state, meta: Optional[dict] = None) -> str:
    """Write ``state`` (a ``train.steps.TrainState``) and ``meta`` under
    ``{directory}/{name}.pt``; returns the path."""
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
        "step": state.step,
        "meta": meta or {},
    }
    return _atomic_write(train_checkpoint_path(directory, name), lambda tmp: torch.save(payload, tmp))


def copy_train_checkpoint(directory: str, src: str, dst: str) -> str:
    """Duplicate checkpoint ``src`` as ``dst`` (a file copy, atomically
    moved into place), without serializing the state again."""
    src_path = train_checkpoint_path(directory, src)
    return _atomic_write(train_checkpoint_path(directory, dst), lambda tmp: shutil.copyfile(src_path, tmp))


def load_train_checkpoint(path: str, state) -> dict:
    """Restore ``state`` in place from a ``save_train_checkpoint`` file (onto
    the devices its tensors already live on); returns the meta dict. A
    checkpoint without an EMA restarts the EMA from the restored params."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.ema is not None:
        ema = payload.get("ema") or {k: p.detach() for k, p in state.model.named_parameters()}
        for k, v in state.ema.items():
            v.copy_(ema[k])
    return dict(payload.get("meta") or {})


def serving_state_dict(
    model_state: Mapping[str, torch.Tensor],
    ema: Optional[Mapping[str, torch.Tensor]],
    use_ema: bool = True,
) -> Dict[str, torch.Tensor]:
    """The weights that validation scores and serving serves, in the
    reference layout: the model's state dict, with the EMA of the
    parameters in place of the live ones when there is one and ``use_ema``,
    without the training-only deep-supervision heads (``ds{i}.*``)."""
    sd = dict(model_state)
    if use_ema and ema:
        sd.update(ema)
    return {k: v for k, v in sd.items() if not _DS_HEAD.match(k)}


def export_train_checkpoint(path: str, output: str, use_ema: bool = True) -> str:
    """Training checkpoint ``path`` (a ``.pt`` file) → reference-layout
    ``.pth`` at ``output``, with the meta keys the JAX package's export
    carries (``exported_from``, ``epoch``, ``monitor``, ``best_monitor``,
    ``config``)."""
    if not path.endswith(TRAIN_SUFFIX) or not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path!r}: expected a training checkpoint file ({{save_dir}}/{{name}}{TRAIN_SUFFIX})"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = payload.get("meta") or {}
    extra = {"exported_from": os.path.abspath(path)}
    extra.update({k: meta[k] for k in ("epoch", "monitor", "best_monitor") if k in meta})
    weights = serving_state_dict(payload["model"], payload.get("ema"), use_ema)
    return save_pth(output, weights, meta.get("config"), extra)


def prune_periodic(directory: str, keep: int, tag: str = "") -> None:
    """Delete all but the newest ``keep`` ``epoch_{e}`` checkpoints, or
    ``epoch_{e}_{tag}`` ones under a tag (0 keeps all)."""
    if keep <= 0:
        return
    directory = os.path.abspath(os.path.expanduser(directory))
    suffix = f"_{tag}{TRAIN_SUFFIX}" if tag else TRAIN_SUFFIX
    found = []
    for entry in os.listdir(directory):
        epoch = entry[len("epoch_"): -len(suffix)] if entry.endswith(suffix) else ""
        if entry.startswith("epoch_") and epoch.isdigit():
            found.append((int(epoch), entry))
    for _, entry in sorted(found)[:-keep]:
        os.remove(os.path.join(directory, entry))
