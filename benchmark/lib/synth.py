"""Inputs and weights made from a seed on the device, in a few large calls."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any non-negative integer:
    folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def state_shapes(n_modalities: int, n_classes: int, base: int, norm: str) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the reference model's state dict, in its order, with its shape."""
    f = [base << k for k in range(5)]
    out: Dict[str, Tuple[int, ...]] = {}

    def double(key, ci, co):
        for i, c_in in ((0, ci), (3, co)):
            out[f"{key}.{i}.weight"] = (co, c_in, 3, 3, 3)
            out[f"{key}.{i}.bias"] = (co,)
            n = f"{key}.{i + 1}"
            out[f"{n}.weight"] = (co,)
            out[f"{n}.bias"] = (co,)
            if norm == "batch":
                out[f"{n}.running_mean"] = (co,)
                out[f"{n}.running_var"] = (co,)
                out[f"{n}.num_batches_tracked"] = ()

    double("inc.conv", n_modalities, f[0])
    for i in range(1, 5):
        double(f"down{i}.maxpool_conv.1.conv", f[i - 1], f[i])
    for i in range(1, 5):
        k = 4 - i
        out[f"up{i}.up.weight"] = (f[k + 1], f[k], 2, 2, 2)
        out[f"up{i}.up.bias"] = (f[k],)
        double(f"up{i}.conv.conv", 2 * f[k], f[k])
    out["outc.weight"] = (n_classes, f[0], 1, 1, 1)
    out["outc.bias"] = (n_classes,)
    return out


def init_state(config: dict, seed: int, device, trained_stats: bool = False) -> Dict[str, torch.Tensor]:
    """A state dict for ``config`` from ``seed``: kaiming-normal (fan_out,
    ReLU gain) conv weights from one draw; zero biases, unit norm scales and
    the initial running statistics (mean 0, variance 1). With
    ``trained_stats`` the biases, norm scales and shifts and running
    statistics are drawn too, from a second draw, so that folding BatchNorm
    into the convs changes every weight, as it does for a trained model."""
    shapes = state_shapes(config["n_modalities"], config["n_classes"], config["base_features"],
                          config["norm_layer"])
    gen = generator(seed, device)
    weights = [k for k, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in weights), generator=gen, device=device)
    small = torch.rand(sum(math.prod(s) for s in shapes.values() if len(s) == 1), generator=gen, device=device)
    out, at, at_small = {}, 0, 0
    for key, shape in shapes.items():
        if len(shape) >= 2:
            fan_out = (shape[1] if key.endswith(".up.weight") else shape[0]) * math.prod(shape[2:])
            n = math.prod(shape)
            out[key] = flat[at: at + n].view(shape).mul_(math.sqrt(2.0 / fan_out))
            at += n
            continue
        if len(shape) == 0:
            out[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        u = small[at_small: at_small + shape[0]]  # U[0, 1)
        at_small += shape[0]
        norm_scale = key.endswith(".weight")
        if key.endswith("running_var"):
            out[key] = (0.8 + 0.45 * u) if trained_stats else torch.ones_like(u)
        elif norm_scale:
            out[key] = (0.9 + 0.2 * u) if trained_stats else torch.ones_like(u)
        else:  # biases, norm shifts, running means
            out[key] = (0.1 * (u - 0.5)) if trained_stats else torch.zeros_like(u)
    return out


def cohort(seed: int, n: int, size: Tuple[int, int, int], n_modalities: int, n_classes: int, device,
           chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """A synthetic training cohort as the device cache holds one: images
    (n, D, H, W, C) bf16 in [0, 1]-like intensities, labels (n, D, H, W, 1)
    uint8. Each case has a sphere of class 1 (radius 12 to 28 voxels) and,
    with K ≥ 3 classes, a smaller one of class 2 inside it; every modality
    is brighter inside the lesion by its own contrast, under noise."""
    gen = generator(seed, device)
    d, h, w = size
    images = torch.empty((n, d, h, w, n_modalities), dtype=torch.bfloat16, device=device)
    labels = torch.empty((n, d, h, w, 1), dtype=torch.uint8, device=device)
    grid = torch.stack(torch.meshgrid(*(torch.arange(s, device=device, dtype=torch.float32) for s in size),
                                      indexing="ij"), -1)  # (D, H, W, 3)
    scale = torch.tensor(size, device=device, dtype=torch.float32)
    contrast = 0.1 + 0.3 * torch.rand(n_modalities, generator=gen, device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        centre = (0.3 + 0.4 * torch.rand((b - a, 1, 1, 1, 3), generator=gen, device=device)) * scale
        radius = (12 + 16 * torch.rand((b - a, 1, 1, 1), generator=gen, device=device))
        r = (grid - centre).norm(dim=-1)  # (B, D, H, W)
        lab = (r < radius).to(torch.uint8)
        if n_classes >= 3:
            lab += (r < radius / 3).to(torch.uint8)
        noise = torch.randn((b - a, d, h, w, n_modalities), generator=gen, device=device)
        images[a:b] = (0.4 + 0.1 * noise + contrast * lab[..., None]).to(torch.bfloat16)
        labels[a:b, ..., 0] = lab
    return images, labels
