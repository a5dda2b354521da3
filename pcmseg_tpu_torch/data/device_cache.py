"""Device-resident dataset cache: batches gathered, cropped and augmented on
the card. The port of ``pcmseg_tpu/data/device_cache.py`` on one device.

When the preprocessed cohort fits ``config.device_data_cache_gb``, the
trainer uploads every case once, as a bf16 image stack (N, D, H, W, C) and a
uint8 label stack (N, D, H, W, 1) on its device, and each step receives a
few row indices and weights instead of a streamed batch (``trainer.py``'s
cached paths). Row r of the stacks is ``dataset.case_list[r]``, or, for the
partial cache, ``dataset.case_list[indices[r]]``. The full stacks are
memoised on the dataset per device, so the folds of a cross-validation run,
which share one dataset, upload them once; a subset (partial) cache is not
memoised and is freed with its trainer (``device_cache.py:92-98``).
``uploads`` counts the stacks built.

The step's randomness: every per-sample scalar (flip flags, the rot90 k,
angle, zoom, jitter, gamma, the noise and blur draws, uniform crop offsets,
the window-mode draws) comes from a CPU ``torch.Generator`` that the caller
seeds from (seed, epoch), so the host knows each one without a device sync
and the CPU and the card draw the same values. Two fields are drawn on the
device, from a generator seeded by a host draw: the noise volume, and the
uniform noise whose masked argmax picks a foreground voxel. The draws
cannot be JAX's (its PRNG is its own; ``device_cache.py:33-35``), so each
transform is held against JAX's at given parameters, and the random parts
by their distribution and invariants.

Images are bf16 between transforms and each transform computes in fp32 and
rounds back, as ``device_augment`` casts back to the image dtype after
every operation. Labels follow the spatial transforms only.

Data-parallel processes (``cache_sharding``, ``_build_multiprocess``,
``_batch_constraint``, ``device_cache.py:53, :172, :568``): the stacks' rows
are split in contiguous blocks over the processes, as JAX shards the case
axis over 'data' (padded up to a multiple of the process count), and each
process decodes and holds only its block. Every process computes the same
row indices for a step; the owners of the rows write them into a zeroed
global batch, which one all-reduce of its bytes makes whole and bitwise
on every process (``collectives.exchange``); every process then crops and
augments the global batch from the same generator, as one process would,
and keeps its own rows (``parallel.sharding.local_rows``). On a data ×
spatial mesh the blocks go by the data coordinate (the ranks of one
spatial group hold the same block), the exchange runs over the data ranks
(the ranks that hold the other blocks), and each rank keeps the D-slab of
its rows after the crop and the augmentation of the whole rows
(``sharding.shard_batch``).
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu_torch.parallel import collectives, multihost, sharding

# stacks built since the count was last set to 0 (memo hits not counted)
uploads = 0


def dataset_device_bytes(n_cases: int, target_size, n_modalities: int) -> int:
    """Device bytes of a cached dataset (bf16 images + uint8 labels)."""
    vox = int(np.prod(target_size))
    return n_cases * vox * (2 * n_modalities + 1)


def _memo_key(device: torch.device) -> str:
    """The memo's key for ``device``: a CUDA device without an index is the
    current one, so 'cuda' and 'cuda:0' share one upload."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def cache_sharding(n_rows: int, shard: Optional[Tuple[int, int]]) -> range:
    """The stack rows a process holds: the contiguous block ``index`` of
    ``count`` over the rows padded up to a multiple of ``count``
    (``device_cache.py:53``); all rows in one process."""
    if shard is None:
        return range(n_rows)
    index, count = shard
    per = -(-n_rows // count)
    return range(min(n_rows, index * per), min(n_rows, (index + 1) * per))


def build_device_cache(
    dataset, device, num_workers: int = 4, indices: Optional[Sequence[int]] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Dict[str, object]:
    """Decode every case (``num_workers`` threads, a bounded window ahead)
    and copy it into the stacks on ``device``: {'images': (N, D, H, W, C)
    bf16, 'labels': (N, D, H, W, 1) uint8, 'rows': the stack rows held}.
    The wire image holds bf16 values, so the cast is exact. ``indices``
    caches only that subset (row r = base case ``indices[r]``, as JAX's
    ``_DatasetView`` maps it). ``shard=(index, count)``: a data-parallel
    process's block of the rows only (:func:`cache_sharding`), decoded by
    this process alone."""
    global uploads
    device = torch.device(device)
    memo = getattr(dataset, "_device_cache_memo", {})
    key = _memo_key(device) if shard is None else (_memo_key(device), tuple(shard))
    if indices is None and key in memo:
        return memo[key]
    cases = [int(i) for i in indices] if indices is not None else list(range(len(dataset)))
    held = cache_sharding(len(cases), shard)
    rows = [cases[r] for r in held]
    n = len(rows)
    images = labels = None
    window = 2 * max(1, num_workers)
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        pending = deque(pool.submit(dataset.load_case, rows[r]) for r in range(min(window, n)))
        nxt = len(pending)
        for row in range(n):
            sample = pending.popleft().result()
            if nxt < n:
                pending.append(pool.submit(dataset.load_case, rows[nxt]))
                nxt += 1
            image = torch.from_numpy(np.ascontiguousarray(sample["image"])).to(torch.bfloat16)
            label = torch.from_numpy(np.ascontiguousarray(sample["label"])).to(torch.uint8)
            if images is None:
                images = torch.empty((n, *image.shape), dtype=torch.bfloat16, device=device)
                labels = torch.empty((n, *label.shape), dtype=torch.uint8, device=device)
            images[row].copy_(image)
            labels[row].copy_(label)
    if images is None:  # a process whose block is empty (more processes than cases) learns the shapes
        sample = dataset.load_case(cases[0])
        images = torch.empty((0, *sample["image"].shape), dtype=torch.bfloat16, device=device)
        labels = torch.empty((0, *sample["label"].shape), dtype=torch.uint8, device=device)
    cache = {"images": images, "labels": labels, "rows": held if shard is not None else None}
    uploads += 1
    if indices is None:
        try:
            memo[key] = cache
            dataset._device_cache_memo = memo
        except AttributeError:
            pass
    return cache


def gather_rows(images, labels, idx, held: Optional[range] = None, comm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``idx`` of the stacks, on every process: from the stacks alone
    in one process; when this process ``held`` only those rows of a
    sharded cache, each process writes the rows it holds into a zeroed
    global batch, which :func:`collectives.exchange` over ``comm`` (default:
    every process; the processes that hold the other blocks) completes
    bitwise (one all-reduce of the images' and labels' bytes)."""
    idx = np.asarray(idx, np.int64)
    if held is None:
        rows = _on_device(idx, images.device)
        return images.index_select(0, rows), labels.index_select(0, rows)
    b, img_n, lab_n = len(idx), int(np.prod(images.shape[1:])), int(np.prod(labels.shape[1:]))
    buf = torch.zeros(b * (2 * img_n + lab_n), dtype=torch.uint8, device=images.device)
    out_img = buf[: 2 * b * img_n].view(torch.bfloat16).view(b, *images.shape[1:])
    out_lab = buf[2 * b * img_n:].view(b, *labels.shape[1:])
    mine = [i for i, r in enumerate(idx) if held.start <= r < held.stop]
    if mine:
        src = _on_device(idx[mine] - held.start, images.device)
        dst = _on_device(np.asarray(mine, np.int64), images.device)
        out_img.index_copy_(0, dst, images.index_select(0, src))
        out_lab.index_copy_(0, dst, labels.index_select(0, src))
    collectives.exchange(buf, comm)
    return out_img, out_lab


# ---- host draws --------------------------------------------------------------


def _rand(gen: torch.Generator) -> float:
    """U[0, 1) from the host generator."""
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def _uniform(gen: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * _rand(gen)


def _randint(gen: torch.Generator, lo: int, hi: int) -> int:
    """An integer in [lo, hi)."""
    return int(torch.randint(lo, hi, (), generator=gen))


def _device_generator(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded by one host draw."""
    return torch.Generator(device=device).manual_seed(_randint(gen, 0, 2**62))


def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host sync (pinned memory,
    non-blocking copy on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---- transforms at given parameters --------------------------------------------


def _affine_warp(img: torch.Tensor, lab: torch.Tensor, angle: float, scale: float):
    """Rotate (H-W plane, radians) and isotropically zoom one ((D, H, W, C),
    (D, H, W, 1)) pair about the volume centre: trilinear image, nearest
    label (round half to even), edge-clamped sampling (``device_cache.py:241-332``).

    Factorised as there: a 1-D linear resample along z with two (D,) index
    vectors, then four corner gathers over the flattened H·W axis with one
    shared (H·W,) index vector for every z-slice and channel. Source
    coordinates are clamped before the floor, so out-of-bounds samples take
    the edge value. The scalars are float32, as JAX traces them."""
    d, h, w = img.shape[:3]
    dev = img.device
    zc, yc, xc = (d - 1) / 2.0, (h - 1) / 2.0, (w - 1) / 2.0
    a = np.float32(angle)
    inv = float(np.float32(1.0) / np.float32(scale))
    cos, sin = float(np.cos(a)), float(np.sin(a))

    zz = torch.arange(d, dtype=torch.float32, device=dev)
    src_z = ((zz - zc) * inv + zc).clamp(0, d - 1)
    z0 = src_z.floor().clamp(0, d - 1)
    fz = (src_z - z0)[:, None, None, None]
    z0i = z0.long()
    z1i = (z0i + 1).clamp(max=d - 1)

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - yc
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - xc
    src_y = ((cos * ys + sin * xs) * inv + yc).clamp(0, h - 1)
    src_x = ((-sin * ys + cos * xs) * inv + xc).clamp(0, w - 1)
    y0 = src_y.floor().clamp(0, h - 1)
    x0 = src_x.floor().clamp(0, w - 1)
    wy = (src_y - y0).reshape(1, -1, 1)
    wx = (src_x - x0).reshape(1, -1, 1)
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=h - 1), (x0i + 1).clamp(max=w - 1)

    def flat(yi, xi):
        return (yi * w + xi).reshape(-1)

    def plane_lerp(vol):  # (D, H*W, C) fp32
        c00 = vol.index_select(1, flat(y0i, x0i))
        c01 = vol.index_select(1, flat(y0i, x1i))
        c10 = vol.index_select(1, flat(y1i, x0i))
        c11 = vol.index_select(1, flat(y1i, x1i))
        c0 = c00 * (1 - wx) + c01 * wx
        c1 = c10 * (1 - wx) + c11 * wx
        return c0 * (1 - wy) + c1 * wy

    x32 = img.float()
    img_z = x32.index_select(0, z0i) * (1 - fz) + x32.index_select(0, z1i) * fz
    out_img = plane_lerp(img_z.reshape(d, h * w, -1)).reshape(img.shape).to(img.dtype)

    zn = src_z.round().clamp(0, d - 1).long()
    yn = src_y.round().clamp(0, h - 1).long()
    xn = src_x.round().clamp(0, w - 1).long()
    lab_z = lab.index_select(0, zn)
    out_lab = lab_z.reshape(d, h * w, -1).index_select(1, flat(yn, xn)).reshape(lab.shape)
    return out_img, out_lab


def _separable_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur with a 5-tap separable kernel of ``sigma`` (floored at
    1e-3), edge padding, fp32 (``device_cache.py:335-350``)."""
    offs = np.arange(-2.0, 3.0, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (offs / np.float32(max(sigma, 1e-3))) ** 2)
    k = (k / k.sum()).tolist()
    x = img.float()
    for ax in range(3):
        n = x.shape[ax]
        base = torch.arange(n, device=x.device)
        out = 0
        for i in range(5):
            out = out + x.index_select(ax, (base + (i - 2)).clamp(0, n - 1)) * k[i]
        x = out
    return x.to(img.dtype)


def _jitter(img: torch.Tensor, sc: float, shift_u: float) -> torch.Tensor:
    """x·sc + shift_u·std (std 1 where it is 0)."""
    x = img.float()
    std = x.std(correction=0)
    shift = shift_u * torch.where(std > 0, std, torch.ones_like(std))
    return (x * sc + shift).to(img.dtype)


def _gamma(img: torch.Tensor, g: float) -> torch.Tensor:
    """Gamma ``g`` on the sample's min-max-normalised scale, mapped back. The
    base is clamped to >= 1e-7: a pow lowered as exp(g·log(base)) returns NaN
    at base 0, the minimum voxel that every sample has (``device_cache.py:440-454``)."""
    x = img.float()
    lo, hi = x.min(), x.max()
    span = (hi - lo).clamp_min(1e-6)
    base = ((x - lo) / span).clamp_min(1e-7)
    return (base.pow(g) * span + lo).to(img.dtype)


def _noise(img: torch.Tensor, sigma_u: float, gen: torch.Generator) -> torch.Tensor:
    """Additive Gaussian noise of σ = sigma_u·max(std, 1e-6), drawn from the
    device generator ``gen``."""
    x = img.float()
    sigma = sigma_u * x.std(correction=0).clamp_min(1e-6)
    return (x + sigma * torch.randn(x.shape, generator=gen, device=x.device)).to(img.dtype)


def _rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    """k quarter turns in the H-W plane of one (D, H, W, C) volume, as
    ``device_augment``'s switch computes them."""
    if k == 1:
        return x.transpose(1, 2).flip(1)
    if k == 2:
        return x.flip(1).flip(2)
    if k == 3:
        return x.transpose(1, 2).flip(2)
    return x


# ---- the batch transforms --------------------------------------------------------


def device_augment(
    images: torch.Tensor,
    labels: torch.Tensor,
    gen: torch.Generator,
    flip: bool = True,
    rot90: bool = True,
    intensity_jitter: float = 0.1,
    scale: float = 0.0,
    rotate_deg: float = 0.0,
    gamma: float = 0.0,
    noise: float = 0.0,
    blur_prob: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample augmentation of a (B, D, H, W, C) batch on its device
    (``device_cache.py:353-475``): flips with p = 0.5 on each axis; H-W
    rot90 by k ∈ {0..3}, only k ∈ {0, 2} when H ≠ W; the warp when
    ``scale`` (zoom U(1 ± scale)) or ``rotate_deg`` (U(± rotate_deg)°) is
    set; intensity scale and shift jitter, the shift scaled by the std;
    gamma exp(U(± gamma)); noise σ = U(0, noise)·max(std, 1e-6); blur with
    σ ~ U(0.5, 1.1) with probability ``blur_prob``. Scalars come from the
    host generator ``gen`` (module docstring)."""
    square = images.shape[2] == images.shape[3]
    out_img, out_lab = [], []
    for img, lab in zip(images, labels):
        if flip:
            for ax in range(3):
                if _rand(gen) < 0.5:
                    img, lab = img.flip(ax), lab.flip(ax)
        if rot90:
            k = _randint(gen, 0, 4)
            if not square:
                k -= k % 2  # odd k would swap the H and W extents
            img, lab = _rot90(img, k), _rot90(lab, k)
        if scale > 0 or rotate_deg > 0:
            ang = _uniform(gen, -rotate_deg, rotate_deg) * (math.pi / 180.0) if rotate_deg > 0 else 0.0
            zoom = 1.0 + _uniform(gen, -scale, scale) if scale > 0 else 1.0
            img, lab = _affine_warp(img, lab, ang, zoom)
        if intensity_jitter > 0:
            sc = 1.0 + _uniform(gen, -intensity_jitter, intensity_jitter)
            img = _jitter(img, sc, _uniform(gen, -intensity_jitter, intensity_jitter))
        if gamma > 0:
            img = _gamma(img, math.exp(_uniform(gen, -gamma, gamma)))
        if noise > 0:
            sigma_u = _uniform(gen, 0.0, noise)
            img = _noise(img, sigma_u, _device_generator(gen, img.device))
        if blur_prob > 0:
            blur, sigma = _rand(gen) < blur_prob, _uniform(gen, 0.5, 1.1)
            if blur:
                img = _separable_blur(img, sigma)
        out_img.append(img)
        out_lab.append(lab)
    return torch.stack(out_img), torch.stack(out_lab)


def _fg_offsets(lab: torch.Tensor, crop, uniform, mode: str, gen: torch.Generator):
    """Device offsets of a crop forced onto the foreground of ``lab`` (D, H,
    W, 1): a voxel drawn uniformly from the label (argmax of U(0.1, 1) noise
    masked to it), the crop centred on it (``'center'``: clip(v − c//2, 0,
    s − c)) or placed uniformly around it (``'window'``); the ``uniform``
    offsets where the label is empty."""
    dims = lab.shape[:3]
    mask = lab[..., 0] > 0
    field = torch.rand(mask.shape, generator=_device_generator(gen, lab.device), device=lab.device)
    flat = torch.where(mask, field * 0.9 + 0.1, torch.zeros_like(field)).reshape(-1).argmax()
    vox = (flat // (dims[1] * dims[2]), (flat // dims[2]) % dims[1], flat % dims[2])
    any_fg = mask.any()
    offs = []
    for v, s, c, o_u in zip(vox, dims, crop, uniform):
        if mode == "center":
            o_fg = (v - c // 2).clamp(0, s - c)
        else:
            lo, hi = (v - c + 1).clamp(0, s - c), v.clamp(0, s - c)
            n = hi - lo + 1
            o_fg = lo + torch.minimum((_rand(gen) * n.float()).long(), n - 1)
        offs.append(torch.where(any_fg, o_fg, o_u))
    return offs


def device_random_crop(
    images: torch.Tensor,
    labels: torch.Tensor,
    gen: torch.Generator,
    crop,
    oversample_fg: float = 0.0,
    mode: str = "center",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random (D, H, W) crop of a gathered (B, D, H, W, C) batch,
    image and label at shared offsets (``device_cache.py:478-565``).
    Uniform offsets, or, with ``oversample_fg`` > 0, some samples forced
    onto foreground: ``'center'`` forces the first n = B − round(B·(1 − p))
    samples (B is the padded batch, as in JAX) and centres the crop on a
    drawn foreground voxel; ``'window'`` forces each sample with
    probability p and places the voxel anywhere in the crop. An empty label
    falls back to the uniform offsets. A forced crop is gathered at its
    device offsets with ``index_select`` (offset + arange(c)); the others
    are slices."""
    b = images.shape[0]
    dims = images.shape[1:4]
    crop = tuple(int(c) for c in crop)
    n_forced = b - int(round(b * (1.0 - oversample_fg)))
    out_img, out_lab = [], []
    for i, (img, lab) in enumerate(zip(images, labels)):
        uniform = [_randint(gen, 0, s - c + 1) for s, c in zip(dims, crop)]
        forced = False
        if oversample_fg > 0.0:
            forced = i < n_forced if mode == "center" else _rand(gen) < oversample_fg
        if forced:
            for ax, o in enumerate(_fg_offsets(lab, crop, uniform, mode, gen)):
                take = o + torch.arange(crop[ax], device=img.device)
                img, lab = img.index_select(ax, take), lab.index_select(ax, take)
        else:
            sl = tuple(slice(o, o + c) for o, c in zip(uniform, crop))
            img, lab = img[sl], lab[sl]
        out_img.append(img)
        out_lab.append(lab)
    return torch.stack(out_img), torch.stack(out_lab)


def cached_batch(images, labels, idx, gen: Optional[torch.Generator], config, held: Optional[range] = None,
                 comm=None):
    """The batch of a cached train step: rows ``idx`` of the stacks
    (:func:`gather_rows`), cropped (``config.train_crop``), then augmented
    (``config.data_augmentation``), on the stacks' device."""
    img, lab = gather_rows(images, labels, idx, held, comm)
    if config.train_crop is not None:
        img, lab = device_random_crop(
            img, lab, gen, config.train_crop,
            oversample_fg=config.oversample_fg, mode=config.oversample_mode,
        )
    if config.data_augmentation:
        img, lab = device_augment(
            img, lab, gen,
            flip=config.aug_flip,
            rot90=config.aug_rot90,
            intensity_jitter=config.aug_intensity_jitter,
            scale=config.aug_scale,
            rotate_deg=config.aug_rotate_deg,
            gamma=config.aug_gamma,
            noise=config.aug_noise,
            blur_prob=config.aug_blur_prob,
        )
    return img, lab


def _sharded(mesh: Optional[sharding.Mesh]):
    """(a batch → this process's part of it, the communicator of the
    exchange) on ``mesh`` (default: every process on 'data')."""
    if not collectives.active():
        return (lambda batch, accum: batch), None
    mesh = mesh or sharding.Mesh(multihost.process_count())
    comm = collectives.mesh_comms(mesh).data

    def local(batch: dict, accum: int) -> dict:
        """This process's rows and D-slab (``parallel.sharding.shard_batch``) of a global batch."""
        return sharding.shard_batch(batch, mesh, accum=accum)

    return local, comm


def make_cached_train_step(config, base_step: Callable, held: Optional[range] = None,
                           mesh: Optional[sharding.Mesh] = None) -> Callable:
    """(state, images, labels, idx, weights, gen) -> the metrics of
    ``base_step`` (the port's ``make_train_step``) on the batch that
    :func:`cached_batch` gathers, crops and augments
    (``device_cache.py:584-621``); in a multi-process job, whose stacks
    hold the rows ``held``, on this process's part of it on ``mesh``."""
    local, comm = _sharded(mesh)

    def step(state, images, labels, idx, weights, gen):
        img, lab = cached_batch(images, labels, idx, gen, config, held, comm)
        batch = {"image": img, "label": lab, "weight": _on_device(weights, img.device)}
        return base_step(state, local(batch, config.accum_steps))

    return step


def make_cached_eval_step(base_eval: Callable, held: Optional[range] = None,
                          mesh: Optional[sharding.Mesh] = None) -> Callable:
    """(state, images, labels, idx, weights) -> the metrics of ``base_eval``
    on rows ``idx`` of the stacks, not augmented (``device_cache.py:624-635``);
    in a multi-process job on this process's part of them on ``mesh``."""
    local, comm = _sharded(mesh)

    def step(state, images, labels, idx, weights):
        img, lab = gather_rows(images, labels, idx, held, comm)
        batch = {"image": img, "label": lab, "weight": _on_device(weights, img.device)}
        return base_eval(state, local(batch, 1))

    return step
