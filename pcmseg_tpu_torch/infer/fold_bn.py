"""Fold frozen BatchNorm statistics into the preceding conv, on a state dict.

The port of ``pcmseg_tpu/infer/fold_bn.py``. For conv → BN at inference:

    w' = w * (gamma / sqrt(var + eps))            per output channel
    b' = (b - mean) * (gamma / sqrt(var + eps)) + beta

computed in float64 and cast back to the conv weight's dtype, exactly as
``_fold_one`` does. The BN entries are dropped, so the result loads strictly
into ``UNet3D(norm_layer='none')``, whose convs then fuse bias and ReLU in
the kernel's epilogue.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

BN_EPS = 1e-5
_BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def has_batchnorm(state_dict: Mapping[str, torch.Tensor]) -> bool:
    return any(k.endswith(".running_mean") for k in state_dict)


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict with every ``<seq>.{i}`` conv + ``<seq>.{i+1}`` BN folded.

    A BN module is recognised by its ``running_mean``; its conv is the
    previous index of the same Sequential.
    """
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        parent, idx = bn.rsplit(".", 1)
        conv = f"{parent}.{int(idx) - 1}"
        scale = state_dict[f"{bn}.weight"].double()
        mult = scale / torch.sqrt(state_dict[f"{bn}.running_var"].double() + BN_EPS)
        w = state_dict[f"{conv}.weight"]
        cbias = state_dict.get(f"{conv}.bias")
        cbias = torch.zeros_like(mult) if cbias is None else cbias.double()
        new_bias = (cbias - state_dict[key].double()) * mult + state_dict[f"{bn}.bias"].double()
        out[f"{conv}.weight"] = (w.double() * mult.reshape(-1, *[1] * (w.dim() - 1))).to(w.dtype)
        out[f"{conv}.bias"] = new_bias.to(w.dtype)
        for suffix in _BN_SUFFIXES:
            out.pop(f"{bn}.{suffix}", None)
    return out
