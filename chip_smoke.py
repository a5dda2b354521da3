#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pcmseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths, training and serving, at the flagship
model's full width and checks every hand-written kernel on them:

  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: compiles csrc/*.cu for sm_90a, one nvcc per source in parallel
     (cached by content hash under build/pcmseg_tpu_torch/);
  3. B1 forward vs plain: the 3³ conv kernel at each of the 14 distinct
     (Ci, Co, size) shapes of a 128³ base-64 forward, bf16, ReLU on and
     off, at N=1 and N=4, against its plain PyTorch version in fp32 from the
     same bf16 inputs, with max|kernel − ref| ≤ 8e-3·|ref| + 1e-3·max|ref|
     (one bf16 rounding plus fp32 reassociation); median CUDA-event times at
     N=1 of the kernel, the plain version and cuDNN's conv alone, and each
     shape's TFLOP/s and share of its bound (the larger of its FLOP at the
     card's 989 TFLOP/s and its bytes, each input read once and each output
     written once, at 3.35 TB/s);
  4. B1 as dx: the 17 transposed shapes (relu off, no bias), same bound;
     times beside the plain version and cuDNN's data gradient alone;
  5. B2 (weight gradient) vs plain: the 14 shapes at N=1, bf16 inputs,
     against the plain version in fp32, max|kernel − ref| ≤ 2e-3·max|ref|
     (fp32 sums of up to 2.1 M bf16 products in another order), two launches
     bitwise equal; times of the kernel, the plain version and cuDNN's
     weight gradient alone, TFLOP/s and share of the bound;
  6. gradients: one 128³ microbatch through the base-64 model in BN
     training mode under the Dice loss; each conv's autograd Function as
     the kernel path ran it, layer by layer, against its plain version on
     the same bf16 tensors (each dW element within 3e-4·Σ|x·dy|, dx
     within B1's bound); the loss and every 3³ conv weight's gradient of the kernel
     path (bf16) no further from the fp32 plain-conv model's than 1.5× the
     plain conv's bf16 error (+1e-3 on relative errors), the BN-preceded
     conv biases left out (their true gradient is 0); beside it, as
     witnesses of why both bf16 gradients lie far from fp32, the fp32
     gradient with the input moved by one bf16 rounding, the same
     comparison under Σ logits·r / numel for a fixed random r, and the
     share of the cotangent each BatchNorm's backward keeps;
  7. train: ``Trainer(config).train()`` on 5 synthetic 128³ NIfTI cases
     in the flagship configuration (batch 4 as 4 microbatches, no remat,
     bf16, Dice, Adam 1e-4) for 2 epochs: finite history, ``latest`` and
     ``best`` checkpoints, exact kernel launch counts (per step 4 × (18 B1
     forward + 17 B1 dx + 18 B2), 18 B1 per validation forward); a run
     killed after epoch 1 and resumed from ``latest`` equals the
     uninterrupted one bit for bit; one case served from ``best.pth``;
  8. time: median warm step time of the kernel step and the plain-conv step
     on one device batch, vol/s, peak device memory; launch counts of a
     remat step (18 more B1 per microbatch); device time by kernel;
  9. serve: three synthetic 5-modality NIfTI cases (two 128³, one
     160×160×144 that is tiled as 8 windows in two batches of 4) through
     ``PredictionServer.run_once`` with a seeded base-64 BatchNorm model
     (90,311,361 parameters, folded on load). Asserts 3 done, uint8 masks
     of each case's shape, and exactly 18 kernel launches per forward.
     Then, on one 128³ case and on the tiled case, the kernel's bf16
     probabilities must be no further from the same model in fp32 (plain
     conv, TF32 off) than 1.5× the distance of the plain conv's bf16
     probabilities (max and mean |dp|), and the two bf16 forwards must
     agree within PLAIN_MAX_DP / PLAIN_MEAN_DP;
 10. profile: where a warm 128³ case's time goes: host decode, device
     path and mask write each timed alone, the device path's time per
     kernel (torch.profiler), and the card's idle share over a warm
     ``run_once`` of four 128³ cases.

Every phase prints its own lines; any failure raises and exits non-zero.
Without a CUDA device, or outside a checkout of the repository, it exits 1
before doing anything. The last lines are the kernels' JSON record (per
kernel the 128³-microbatch sums of the kernel, its plain version, cuDNN's
call (``library_ms``) and the bound; B1's ``dx_*`` keys are its dx use), the
nvidia-smi line, and the device JSON.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (Ci, Co, cubic size, layers of a 128³ forward with this shape)
CONV_SHAPES = (
    (5, 64, 128, 1), (64, 64, 128, 2), (64, 128, 64, 1), (128, 128, 64, 2),
    (128, 256, 32, 1), (256, 256, 32, 2), (256, 512, 16, 1), (512, 512, 16, 2),
    (512, 1024, 8, 1), (1024, 1024, 8, 1), (1024, 512, 16, 1), (512, 256, 32, 1),
    (256, 128, 64, 1), (128, 64, 128, 1),
)
CASES = {"case_a": (128, 128, 128), "case_b": (128, 128, 128), "case_c": (160, 160, 144)}
BASE_FEATURES = 64
N_PARAMS = 90_311_361
# the kernel's bf16 forward may be at most this many times further from the
# fp32 forward than the plain conv's bf16 forward is (max and mean |dp|)
BF16_MARGIN = 1.5
# and the two bf16 forwards agree with each other within these bounds on
# |p_kernel - p_plain|: each rounds activations to bf16 at other points
# through 18 convs, and each lies within ~0.05 (max) / 5e-3 (mean) of fp32
PLAIN_MAX_DP = 0.1
PLAIN_MEAN_DP = 1e-2
# profile phase: 128³ cases in the warm run_once, forwards under torch.profiler
PROFILE_CASES = 4
PROFILE_FORWARDS = 5
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16 tensor
# rate and HBM3 bandwidth, for the least time a conv could take
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def conv_bound(ci: int, co: int, size: int, n: int = 1, dw: bool = False):
    """(least ms, FLOP, whether the operations and not the bytes bound it)
    of one 3³ conv at these shapes on one H100: the larger of its FLOP at
    PEAK_FLOPS and its bytes at PEAK_BYTES, each input read once and each
    output written once. Forward and dx read x (or dy) and the bf16 weight
    and write y (or dx), plus the fp32 bias; dW reads x and dy and writes
    the fp32 (27, Ci, Co) gradient. Ci is the real channel count (5 at the
    input conv, not the 8 the kernel reads)."""
    vox = n * size**3
    flop = 2 * 27 * ci * co * vox
    moved = 2 * vox * (ci + co) + (4 * 27 * ci * co if dw else 2 * 27 * ci * co + 4 * co)
    ops_s, bytes_s = flop / PEAK_FLOPS, moved / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, flop, ops_s >= bytes_s


def shape_line(k_ms: float, bound_ms: float, flop: int) -> str:
    return f"kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s, {bound_ms / k_ms:.3f} of the bound {bound_ms:.4f} ms)"


def summed(rows) -> dict:
    """Sums over layers of [(layers, kernel ms, plain ms, library ms, bound ms,
    ops-bound ms)]: the JSON record's times."""
    ms = sum(n * k for n, k, *_ in rows)
    ops = sum(n * o for n, *_, o in rows)
    bound = sum(n * b for n, _, _, _, b, _ in rows)
    return {"ms": ms, "plain_ms": sum(n * p for n, _, p, *_ in rows),
            "library_ms": sum(n * c for n, _, _, c, *_ in rows), "bound_ms": bound,
            "bound_by": "operations" if ops >= bound / 2 else "bytes"}


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_kernels(device, card: str, batches) -> dict:
    """Kernel vs plain version at each shape and each batch size in
    ``batches``, timed at the first; returns the JSON record's numbers."""
    import torch
    import torch.nn.functional as F

    from pcmseg_tpu_torch.ops.kernels import conv3d

    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(0)
    for ci, co, s, layers in CONV_SHAPES:
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        b = torch.randn((co,), generator=g, device=device) * 0.1
        packed = conv3d.pack_weight(w, torch.bfloat16)
        shape_err = 0.0
        for n in reversed(batches):  # the last x made is the timed one
            x = torch.randn((n, s, s, s, ci), generator=g, device=device).to(torch.bfloat16)
            for relu in (True, False):
                got = conv3d.conv3x3x3(x, packed, b, relu)
                torch.cuda.synchronize()
                ref = conv3d.conv3x3x3_reference(x.float(), packed.float(), b, relu)
                err = (got.float() - ref).abs()
                bound = 8e-3 * ref.abs() + 1e-3 * ref.abs().max()
                if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
                    raise AssertionError(
                        f"conv {ci}->{co} @{s}^3 N={n} relu={relu}: kernel disagrees with the "
                        f"plain version (max err {err.max().item():.4g}, worst err/bound "
                        f"{(err / bound).max().item():.3g})"
                    )
                shape_err = max(shape_err, err.max().item())
                del got, ref, err, bound
        max_err = max(max_err, shape_err)
        k_ms = median_ms(lambda: conv3d.conv3x3x3(x, packed, b, True))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(x, packed, b, True))
        w5 = conv3d.unpack_weight(packed, ci).contiguous(memory_format=torch.channels_last_3d)
        xc = x.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: F.conv3d(xc, w5, padding=1))
        bound, flop, ops = conv_bound(ci, co, s, batches[0])
        log(f"conv {ci}->{co} @{s}^3 x{layers}: ok at N={'/'.join(map(str, batches))}, "
            f"max_abs_err {shape_err:.4g}; N={batches[0]}: {shape_line(k_ms, bound, flop)}, "
            f"plain {p_ms:.4f} ms, cudnn conv alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del x, w, b, packed
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"forward, 18 layers of one 128^3 microbatch: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
        f"cudnn conv alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


def write_cases(root: str, modalities) -> None:
    """Synthetic int16 MRI-like volumes: a bright ellipsoid plus noise."""
    import numpy as np

    from pcmseg_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(0)
    for case_id, shape in CASES.items():
        z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape], indexing="ij")
        blob = np.exp(-3 * (z**2 + 2 * y**2 + x**2))
        for i, m in enumerate(modalities):
            os.makedirs(os.path.join(root, case_id, m))
            vol = 300 * blob * (1 + 0.25 * i) + rng.normal(0, 25, size=shape).astype(np.float32)
            write_nifti(vol.astype(np.int16), os.path.join(root, case_id, m, "image.nii"))


def make_checkpoint(path: str, config, probe_case: str, device) -> None:
    """Seeded BatchNorm model with non-trivial running statistics, its
    output bias centred on the median logit of ``probe_case``."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import BatchNorm, UNet3D, param_count
    from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth

    g = torch.Generator().manual_seed(1234)
    model = UNet3D.from_config(config, generator=g)
    if param_count(model) != N_PARAMS:
        raise AssertionError(f"{param_count(model)} parameters, expected {N_PARAMS}")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.05, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    save_pth(path, model.state_dict(), config.to_dict())
    del model
    probe = Predictor(config, path, device=device)
    p = probe.predict_probs(probe.load_case(probe_case)[0])
    if not np.isfinite(p).all():
        raise AssertionError("non-finite probabilities")
    p = np.clip(p, 1e-6, 1 - 1e-6)
    sd, snap = load_pth(path)
    sd["outc.bias"] -= float(np.median(np.log(p / (1 - p))))
    save_pth(path, sd, snap)


def expected_forwards(config) -> int:
    from pcmseg_tpu_torch.infer.sliding_window import tile_starts

    total = 0
    for shape in CASES.values():
        if config.sliding_window or any(s > w for s, w in zip(shape, config.window_size)):
            n = len(tile_starts(shape, config.window_size, config.window_overlap))
            total += math.ceil(n / min(config.window_tile_batch, n))
        else:
            total += 1
    return total


def serve(work: str, config, device, card: str):
    """The port's main path: PredictionServer.run_once over ``CASES``.
    Returns (the kernel launches counted during that run, the server)."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.data.io import read_volume
    from pcmseg_tpu_torch.infer.serve import PredictionServer
    from pcmseg_tpu_torch.ops.kernels import conv3d

    inbox, outbox, pth = (os.path.join(work, n) for n in ("inbox", "outbox", "model.pth"))
    t0 = time.perf_counter()
    write_cases(inbox, config.modalities)
    first = sorted(CASES)[0]
    make_checkpoint(pth, config, os.path.join(inbox, first), device)
    server = PredictionServer(config, pth, inbox, outbox, min_age=0.0, device=device)
    log(f"serve setup (cases, checkpoint, load + fold) {time.perf_counter() - t0:.1f} s")

    conv3d.launches = 0
    t0 = time.perf_counter()
    stats = server.run_once()
    wall = time.perf_counter() - t0
    launches = conv3d.launches
    forwards = expected_forwards(server.config)
    if stats != {"done": len(CASES), "failed": 0, "skipped": 0, "waiting": 0}:
        raise AssertionError(f"serve stats {stats}")
    if launches != 18 * forwards:
        raise AssertionError(f"{launches} conv kernel launches for {forwards} forwards, expected {18 * forwards}")
    log(f"served {stats['done']} cases, {forwards} forwards, {launches} conv kernel launches "
        f"(18 per forward), {wall:.2f} s cold [{card}]")
    for case_id, shape in CASES.items():
        mask = read_volume(os.path.join(outbox, case_id, "segmentation.nii.gz")).data
        if mask.dtype != np.uint8 or mask.shape != shape or not set(np.unique(mask)) <= {0, 1}:
            raise AssertionError(f"{case_id}: mask {mask.dtype} {mask.shape}, expected uint8 {shape}")
        log(f"  {case_id} {shape}: cold latency {server.latencies[case_id]:.3f} s, "
            f"foreground {mask.mean():.3f}")

    # warm serving: the same cases again, end to end (decode, H2D, forward, D2H, write)
    shutil.rmtree(outbox)
    t0 = time.perf_counter()
    server.run_once()
    wall = time.perf_counter() - t0
    log(f"warm serve: {len(CASES)} cases in {wall:.3f} s = {len(CASES) / wall:.3f} vol/s [{card}]")
    for case_id in sorted(CASES):
        log(f"  {case_id}: warm latency {server.latencies[case_id]:.3f} s [{card}]")

    # the device path alone (H2D, forward, threshold, D2H), kernel and plain conv
    predictor = server.predictor
    image, _ = predictor.load_case(os.path.join(inbox, first))

    def device_path_seconds():
        best = []
        for _ in range(3):
            t = time.perf_counter()
            predictor.predict_mask(image)
            best.append(time.perf_counter() - t)
        return min(best)

    kernel_s = device_path_seconds()
    with plain_conv(predictor.model, torch.bfloat16):
        plain_s = device_path_seconds()
    log(f"{first} device path (H2D, forward, threshold, D2H): kernel {kernel_s * 1e3:.1f} ms "
        f"= {1 / kernel_s:.2f} vol/s, plain conv {plain_s * 1e3:.1f} ms [{card}]")

    # numerics as served: whole-volume (N=1) and tiled (N=window_tile_batch)
    check_probs(predictor, image, first)
    tiled = max(CASES, key=lambda c: math.prod(CASES[c]))
    check_probs(predictor, predictor.load_case(os.path.join(inbox, tiled))[0], tiled)
    if device.type == "cuda":
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, server


@contextlib.contextmanager
def plain_conv(model, dtype):
    """Run ``model`` with the plain conv in place of the kernel, in ``dtype``."""
    from pcmseg_tpu_torch.models import unet3d
    from pcmseg_tpu_torch.ops.kernels import conv3d

    saved = model.dtype
    unet3d.conv3x3x3, model.dtype = conv3d.conv3x3x3_reference, dtype
    try:
        yield
    finally:
        unet3d.conv3x3x3, model.dtype = conv3d.conv3x3x3, saved


def check_probs(predictor, image, label: str) -> None:
    """Hold the kernel's bf16 probabilities on ``image`` (through
    ``predict_probs``, whole-volume or tiled as served) against the plain
    conv's bf16 forward and the same model in fp32 (plain conv, TF32 off)."""
    import numpy as np
    import torch

    probs = predictor.predict_probs(image)[..., 0]
    with plain_conv(predictor.model, torch.bfloat16):
        plain = predictor.predict_probs(image)[..., 0]
    with plain_conv(predictor.model, torch.float32):
        exact = predictor.predict_probs(image)[..., 0]
    if not all(np.isfinite(a).all() for a in (probs, plain, exact)):
        raise AssertionError(f"{label}: non-finite probabilities")
    err_k, err_p = np.abs(probs - exact), np.abs(plain - exact)
    for name, p, err in (("kernel", probs, err_k), ("plain conv", plain, err_p)):
        flips = (p > 0.5) != (exact > 0.5)
        log(f"{label} bf16 {name} vs fp32: max|dp| {err.max():.4g}, mean|dp| {err.mean():.3g}, "
            f"mask voxels differing {int(flips.sum())} of {flips.size}, the farthest at "
            f"|p_fp32-0.5| {np.abs(exact[flips] - 0.5).max() if flips.any() else 0.0:.3g}")
    if err_k.max() > BF16_MARGIN * err_p.max() + 1e-3 or err_k.mean() > BF16_MARGIN * err_p.mean() + 1e-4:
        raise AssertionError(
            f"{label}: the kernel's bf16 forward is further from fp32 than {BF16_MARGIN}x the plain conv's"
        )
    dp = np.abs(probs - plain)
    log(f"{label} bf16 kernel vs bf16 plain conv: max|dp| {dp.max():.4g} (bound {PLAIN_MAX_DP}), "
        f"mean|dp| {dp.mean():.3g} (bound {PLAIN_MEAN_DP})")
    if dp.max() > PLAIN_MAX_DP or dp.mean() > PLAIN_MEAN_DP:
        raise AssertionError(f"{label}: the kernel's probabilities disagree with the plain conv's")


def profile(work: str, server, card: str) -> None:
    """Where a warm 128³ case's time goes, on ``server``'s
    resident model. Host decode, device path and mask write of one case,
    each alone (medians of 5); the device time of PROFILE_FORWARDS
    forwards per kernel (torch.profiler); warm run_once of PROFILE_CASES
    128³ cases, unprofiled for vol/s, then profiled for the card's idle
    share (1 − the union of device activity over run_once's span)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    predictor = server.predictor
    inbox, outbox = os.path.join(work, "profile_inbox"), os.path.join(work, "profile_outbox")
    source = min(CASES, key=lambda c: math.prod(CASES[c]))  # a whole-volume case
    for i in range(PROFILE_CASES):
        shutil.copytree(os.path.join(work, "inbox", source), os.path.join(inbox, f"case_{i}"))
    case = os.path.join(inbox, "case_0")

    def median_ms_host(fn, n=5):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[n // 2]

    image, reference = predictor.load_case(case)
    mask = predictor.predict_mask(image)
    probe = os.path.join(work, "probe", "segmentation.nii.gz")
    decode = median_ms_host(lambda: predictor.load_case(case))
    device_path = median_ms_host(lambda: predictor.predict_mask(image))
    write = median_ms_host(lambda: predictor.save_mask(mask, reference, probe))
    log(f"profile, one {CASES[source]} case alone: host decode + normalize {decode:.1f} ms, device path "
        f"{device_path:.1f} ms, mask write {write:.1f} ms [{card}]")

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities) as prof:
        for _ in range(PROFILE_FORWARDS):
            predictor.predict_mask(image)
    kernels = {}  # device activity (kernels, copies) by name: [us, count]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.end - e.time_range.start
            row[1] += 1
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    rows = sorted(((us, count, name) for name, (us, count) in kernels.items()), reverse=True)
    per = 1e3 * PROFILE_FORWARDS
    conv_us = sum(us for us, _, name in rows if "conv3x3x3" in name or "splitk" in name)
    log(f"profile, device time per device path: {sum(r[0] for r in rows) / per:.3f} ms, of "
        f"which the conv kernel {conv_us / per:.3f} ms [{card}]")
    for us, count, key in rows[:16]:
        log(f"  {us / per:8.3f} ms  {count / PROFILE_FORWARDS:5.1f}x  {key[:110]}")

    server.input_root, server.output_dir = inbox, outbox
    done = server.stats["done"]
    t0 = time.perf_counter()
    stats = server.run_once()
    wall = time.perf_counter() - t0
    if stats["done"] - done != PROFILE_CASES:
        raise AssertionError(f"profile serve stats {stats}, {done} done before")
    shutil.rmtree(outbox)
    with torch_profile(activities=activities) as prof:
        with record_function("profile_run_once"):
            server.run_once()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == "profile_run_once" and e.device_type == DeviceType.CPU)
    busy, end = 0.0, span.start
    for lo, hi in sorted(
        (max(e.time_range.start, span.start), min(e.time_range.end, span.end)) for e in events
        if e.device_type == DeviceType.CUDA and e.name != "profile_run_once"
    ):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device activity in run_once")
    log(f"profile, warm run_once of {PROFILE_CASES} such cases: {PROFILE_CASES / wall:.3f} vol/s "
        f"unprofiled; profiled: card idle {1 - busy / (span.end - span.start):.3f} of "
        f"{(span.end - span.start) / 1e3:.1f} ms [{card}]")


# ---- the training path (slice 2) ------------------------------------------------

# the 17 dx convs: B1 on the flipped, transposed weight (Ci <-> Co), every
# conv but the input conv, whose input (the image) needs no gradient
DX_SHAPES = tuple((co, ci, s, layers) for ci, co, s, layers in CONV_SHAPES if ci % 8 == 0)
# B2 against the plain version in fp32 from the same bf16 inputs: fp32 sums
# of up to 2.1 M bf16 products each, in another order
DW_BOUND = 2e-3
# the conv Function's dW in the model against the plain version, per element,
# relative to Σ|x·dy| (the scale of an fp32 sum's rounding): fp32 sums over
# up to 2.1 M voxels, each split's chunk accumulated in order, reach 6.75e-5
# of it (128->64 @128^3). A missing corner tap is 7.7e-3 of it, a dW 10% off
# 7.9e-4 (the input conv).
DW_SUM_BOUND = 3e-4
# the flagship training configuration (bench.py:47-60): batch 4 as 4
# accumulated microbatches of 1, no remat, 128^3, bf16, Dice, Adam 1e-4
SIZE = 128
TRAIN = dict(batch_size=4, accum_steps=4, remat=False, target_size=(SIZE,) * 3,
             compute_dtype="bfloat16", loss="dice", learning_rate=1e-4, num_epochs=2)
TRAIN_CASES = 5  # 4 train, 1 val (val_fraction 0.2)
TIME_STEPS = 5
# the kernel path's bf16 gradient may be at most this many times further
# from the fp32 gradient than the plain conv's bf16 gradient is, plus an
# absolute slack on the relative errors for near-equal ones
GRAD_SLACK = 1e-3


def check_dw_kernels(device, card: str) -> dict:
    """B2 against its plain version at the 14 shapes (N=1, bf16 inputs, fp32
    reference with TF32 off), two launches bitwise equal; median times of
    the kernel, the plain version and cuDNN's weight gradient alone."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(1)
    for ci, co, s, layers in CONV_SHAPES:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device).to(torch.bfloat16)
        dy = torch.randn((1, s, s, s, co), generator=g, device=device).to(torch.bfloat16)
        got = conv3d_grad.conv3x3_dw(x, dy)
        again = conv3d_grad.conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        ref = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
        err = (got - ref).abs().max().item()
        bound = DW_BOUND * ref.abs().max().item()
        if not bool(torch.isfinite(got).all()) or err > bound:
            raise AssertionError(f"dW {ci}->{co} @{s}^3: kernel disagrees with the plain version "
                                 f"(max err {err:.4g}, bound {bound:.4g})")
        if not torch.equal(got, again):
            raise AssertionError(f"dW {ci}->{co} @{s}^3: two launches differ")
        max_err = max(max_err, err)
        del got, again, ref
        k_ms = median_ms(lambda: conv3d_grad.conv3x3_dw(x, dy))
        p_ms = median_ms(lambda: conv3d_grad.conv3x3_dw_reference(x, dy))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.nn.grad.conv3d_weight(xc, (co, ci, 3, 3, 3), dyc, padding=1))
        least, flop, ops = conv_bound(ci, co, s, dw=True)
        log(f"dW {ci}->{co} @{s}^3 x{layers}: ok, max_abs_err {err:.4g} (bound {bound:.4g}), bitwise "
            f"repeat; {shape_line(k_ms, least, flop)}, plain {p_ms:.4f} ms, cudnn wgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, least, least if ops else 0.0))
        del x, dy
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"dW, 18 layers of one 128^3 microbatch: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
        f"cudnn wgrad alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


def check_dx_kernels(device, card: str) -> dict:
    """B1 as dx (relu off, no bias) at the 17 transposed shapes, N=1, against
    its plain version, with B1's bound; median times of the kernel, the
    plain version and cuDNN's data gradient alone."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d

    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(2)
    for ci, co, s, layers in DX_SHAPES:
        dy = torch.randn((1, s, s, s, ci), generator=g, device=device).to(torch.bfloat16)
        w = torch.randn((ci, co, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), torch.bfloat16)
        got = conv3d.conv3x3x3(dy, packed, None, False)
        torch.cuda.synchronize()
        ref = conv3d.conv3x3x3_reference(dy.float(), packed.float(), None, False)
        err = (got.float() - ref).abs()
        bound = 8e-3 * ref.abs() + 1e-3 * ref.abs().max()
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"dx {ci}->{co} @{s}^3: kernel disagrees with the plain version "
                                 f"(max err {err.max().item():.4g})")
        max_err = max(max_err, err.max().item())
        del got, ref, err, bound
        k_ms = median_ms(lambda: conv3d.conv3x3x3(dy, packed, None, False))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(dy, packed, None, False))
        # cuDNN's data gradient of the layer (ci <- co here), as autograd
        # calls it: the layer's own weight and a real channels-last input
        w_bf = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        dyc = dy.permute(0, 4, 1, 2, 3)
        xc = torch.empty((1, s, s, s, co), dtype=torch.bfloat16, device=device).permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.ops.aten.convolution_backward(
            dyc, xc, w_bf, None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1, (True, False, False)))
        bound, flop, ops = conv_bound(ci, co, s)
        log(f"dx {ci}->{co} @{s}^3 x{layers}: ok; {shape_line(k_ms, bound, flop)}, plain {p_ms:.4f} ms, "
            f"cudnn dgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del dy, w, packed, w_bf, dyc, xc
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"dx, 17 layers of one 128^3 microbatch: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
        f"cudnn dgrad alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


@contextlib.contextmanager
def plain_train_conv(model, dtype):
    """Train ``model`` with the plain conv (autograd of F.conv3d) in ``dtype``."""
    from pcmseg_tpu_torch.models import unet3d
    from pcmseg_tpu_torch.ops import hybrid_conv

    saved = model.dtype
    unet3d.conv3x3_train, model.dtype = hybrid_conv.conv3x3_plain, dtype
    try:
        yield
    finally:
        unet3d.conv3x3_train, model.dtype = hybrid_conv.conv3x3, saved


def blob_label(shape, device):
    import torch

    z, y, x = torch.meshgrid(*[torch.linspace(-1, 1, n, device=device) for n in shape], indexing="ij")
    return ((z**2 + 2 * y**2 + x**2) < 0.3).to(torch.uint8)[..., None]


def bn_surviving_share(model):
    """Hooks on every BatchNorm of ``model`` that record, for each backward,
    the share of the cotangent that BatchNorm's backward keeps:
    ‖dy − mean(dy) − x̂·mean(dy·x̂)‖ / ‖dy‖ per layer (1: nothing cancels).
    Returns (the list it fills, the hook handles)."""
    from pcmseg_tpu_torch.models.unet3d import BatchNorm

    shares, handles = [], []

    def on_forward(module, inputs, out):
        x = inputs[0]

        def on_grad(dy):
            dims = tuple(range(x.dim() - 1))
            xf, dyf = x.float(), dy.float()
            xh = (xf - xf.mean(dims)) * (xf.var(dims, unbiased=False) + module.eps).rsqrt()
            kept = dyf - dyf.mean(dims) - xh * (dyf * xh).mean(dims)
            shares.append((kept.norm() / dyf.norm()).item())

        out.register_hook(on_grad)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            handles.append(m.register_forward_hook(on_forward))
    return shares, handles


@contextlib.contextmanager
def conv_io(model):
    """Record, for each 3^3 conv of ``model``, what its autograd Function
    saw and gave in the next forward and backward: {name: {'x', 'dy', 'dx'}}
    ('dx' only where x needs a gradient; each conv's x has no other
    consumer, so its gradient is the Function's dx)."""
    from pcmseg_tpu_torch.models.unet3d import Conv3x3

    records, handles = {}, []

    def hook(name):
        def on_forward(module, inputs, out):
            rec = records.setdefault(name, {"x": inputs[0]})
            out.register_hook(lambda dy: rec.__setitem__("dy", dy))
            if inputs[0].requires_grad:
                inputs[0].register_hook(lambda dx: rec.__setitem__("dx", dx))
        return on_forward

    for name, m in model.named_modules():
        if isinstance(m, Conv3x3):
            handles.append(m.register_forward_hook(hook(name)))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()


def check_conv_function(model, records, grads, card: str) -> None:
    """Each conv's Function, as the kernel path ran it in the model: its dW
    (the parameter's gradient) against the plain fp32 weight gradient of
    the same bf16 x and dy, each element within DW_SUM_BOUND·Σ|x·dy|; its dx against the
    plain fp32 conv of dy with the flipped, transposed bf16 weight, within
    B1's bound. (db is Σ dy, which BatchNorm after every conv makes 0 up
    to rounding: the CPU tests hold it.)"""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    worst = {"dW": (0.0, ""), "dx": (0.0, "")}
    for name, rec in records.items():
        w = model.get_submodule(name).weight.detach()
        x, dy = rec["x"].float(), rec["dy"].float()
        ref = conv3d_grad.conv3x3_dw_reference(x, dy).permute(4, 3, 0, 1, 2)
        # Σ|x·dy| per element: the scale of an fp32 sum's rounding, which
        # |ref| is not where the products cancel (x after ReLU, dy of zero mean)
        scale = conv3d_grad.conv3x3_dw_reference(x.abs(), dy.abs()).permute(4, 3, 0, 1, 2)
        diff = (grads[name + ".weight"] - ref).abs()
        err = (diff / scale.clamp_min(1e-30)).max().item()
        worst["dW"] = max(worst["dW"], (err, name))
        if not err <= DW_SUM_BOUND:
            raise AssertionError(f"{name}: the Function's dW is {err:.3g}·Σ|x·dy| from the plain "
                                 f"version's (bound {DW_SUM_BOUND})")
        if "dx" in rec:
            w_t = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), torch.bfloat16).float()
            ref = conv3d.conv3x3x3_reference(dy, w_t, None, False)
            err = (rec["dx"].float() - ref).abs()
            bound = 8e-3 * ref.abs() + 1e-3 * ref.abs().max()
            worst["dx"] = max(worst["dx"], ((err / bound).max().item(), name))
            if not bool((err <= bound).all()):
                raise AssertionError(f"{name}: the Function's dx disagrees with the plain version "
                                     f"(worst err/bound {(err / bound).max().item():.3g})")
        del x, dy, ref
    log(f"conv Function in the model, {len(records)} convs ({sum('dx' in r for r in records.values())} with dx): "
        f"dW worst {worst['dW'][0]:.3g}·Σ|x·dy| at {worst['dW'][1]} (bound {DW_SUM_BOUND}), dx worst "
        f"err/bound {worst['dx'][0]:.3g} at {worst['dx'][1]} [{card}]")


def check_gradients(device, card: str) -> None:
    """One 128^3 microbatch through the full-width model in BN training mode.

    Under the training loss (soft Dice): each 3^3 conv's autograd Function
    as the kernel path ran it, held layer by layer against its plain
    version on the same bf16 tensors (``check_conv_function``); then the
    loss and every parameter's gradient from the kernel path (bf16), the
    plain conv (bf16) and the plain conv in fp32 (TF32 off), each 3^3 conv
    weight's kernel gradient no further from fp32 than BF16_MARGIN times
    the plain conv's (+ GRAD_SLACK). Both bf16 gradients lie far from fp32
    at this random init, so beside them: fp32 again with the input moved by
    one bf16 rounding (the gradient's own sensitivity), the same comparison
    under Σ logits·r / numel for a fixed random r, and the share of the
    cotangent each BatchNorm's backward keeps."""
    import torch

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.ops.losses import dice_loss

    model = UNet3D(base_features=BASE_FEATURES, generator=torch.Generator().manual_seed(5)).to(device).train()
    g = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((1, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16)
    label = blob_label((SIZE,) * 3, device)[None]
    r = torch.randn((1, SIZE, SIZE, SIZE, 1), generator=g, device=device)
    # x moved by one bf16 rounding (±2^-9 relative), in fp32
    x_moved = x.float() * (1 + 2.0**-9 * (2 * torch.randint(0, 2, x.shape, generator=g, device=device) - 1))
    losses = {
        "dice": lambda logits: dice_loss(logits, label),
        "random cotangent": lambda logits: (logits.float() * r).mean(),
    }

    def grads(loss_of, inp=x):
        model.zero_grad(set_to_none=True)
        loss = loss_of(model(inp))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.float().clone() for k, p in model.named_parameters()}

    for loss_name, loss_of in losses.items():
        conv3d.launches = conv3d_grad.launches = 0
        with conv_io(model) if loss_name == "dice" else contextlib.nullcontext({}) as records:
            loss_k, g_k = grads(loss_of)
        if (conv3d.launches, conv3d_grad.launches) != (18 + 17, 18):
            raise AssertionError(f"kernel path launched B1 {conv3d.launches}x, B2 {conv3d_grad.launches}x; "
                                 "expected 35 and 18")
        if loss_name == "dice":
            check_conv_function(model, records, g_k, card)
        for rec in records.values():
            rec.clear()  # a record's x holds a hook that holds the record: free it now, not at gc
        del records
        with plain_train_conv(model, torch.bfloat16):
            loss_p, g_p = grads(loss_of)
        shares, handles = bn_surviving_share(model)
        with plain_train_conv(model, torch.float32):
            loss_32, g_32 = grads(loss_of)
            for h in handles:
                h.remove()
            _, g_moved = grads(loss_of, x_moved)
        shares.sort()
        log(f"gradient check ({loss_name}), one 128^3 microbatch, base 64, BN train mode: loss kernel "
            f"{loss_k:.6g}, plain bf16 {loss_p:.6g}, fp32 {loss_32:.6g}; fp32 BatchNorm backward keeps "
            f"{shares[len(shares) // 2]:.4g} of the cotangent (median of {len(shares)} layers, least "
            f"{shares[0]:.4g}) [{card}]")
        if abs(loss_k - loss_32) > BF16_MARGIN * abs(loss_p - loss_32) + 1e-4:
            raise AssertionError(f"{loss_name}: the kernel path's loss is further from fp32 than the plain conv's")
        conv_rows, other_rows = [], []  # in forward order
        for k, ref in g_32.items():
            parts = k.split(".")
            conv = ".conv." in k and parts[-2] in ("0", "3")  # a 3^3 conv of a DoubleConv
            if conv and parts[-1] == "bias":
                continue  # BatchNorm follows: the true gradient is 0, computed values are noise
            norm = ref.norm().item()
            rel_k = (g_k[k] - ref).norm().item() / norm
            rel_p = (g_p[k] - ref).norm().item() / norm
            rel_moved = (g_moved[k] - ref).norm().item() / norm
            (conv_rows if conv else other_rows).append((rel_k / max(rel_p, 1e-12), k, rel_k, rel_p, rel_moved))
            if not math.isfinite(rel_k):
                raise AssertionError(f"{loss_name} {k}: non-finite kernel-path gradient")
        for ratio, k, rel_k, rel_p, _ in conv_rows:
            if rel_k > BF16_MARGIN * rel_p + GRAD_SLACK:
                raise AssertionError(f"{loss_name} {k}: kernel gradient rel err {rel_k:.4g} vs plain bf16 "
                                     f"{rel_p:.4g}")
        if loss_name == "dice":
            log("  dice, ||g - g32||/||g32|| of the 3^3 conv weights from the output back (kernel / plain bf16 / "
                "fp32 with x moved): " + ", ".join(f"{k[:-len('.weight')]} {rk:.3g}/{rp:.3g}/{rm:.3g}"
                                                   for _, k, rk, rp, rm in reversed(conv_rows)))
        for name, rows in (("3^3 conv weights", conv_rows), ("other parameters", other_rows)):
            rows.sort(reverse=True)
            med = [sorted(row[i] for row in rows)[len(rows) // 2] for i in (2, 3, 4)]
            log(f"  {loss_name}, {len(rows)} {name}: ||g - g32||/||g32|| median kernel {med[0]:.4g}, plain bf16 "
                f"{med[1]:.4g}, fp32 with x moved by one bf16 rounding {med[2]:.4g}; worst kernel/plain "
                f"{rows[0][0]:.3f} at {rows[0][1]} ({rows[0][2]:.4g} / {rows[0][3]:.4g}) [{card}]")
        del g_k, g_p, g_32, g_moved
    del model, x, x_moved, r
    torch.cuda.empty_cache()


def write_train_tree(root: str, modalities, n_cases: int) -> None:
    """Synthetic 128^3 cases in the training layout
    ({root}/BPH-PCA/BPH/{modality}/{case}.nii.gz, labels under ROI(BPH+PCA))."""
    import numpy as np

    from pcmseg_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(3)
    shape = TRAIN["target_size"]
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape], indexing="ij")
    for i in range(n_cases):
        case = f"case{i:03d}"
        c = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        r2 = (z - c[0]) ** 2 + 2 * (y - c[1]) ** 2 + (x - c[2]) ** 2
        label = (r2 < 0.15).astype(np.uint8)
        for j, m in enumerate(modalities):
            vol = 300 * np.exp(-3 * r2) * (1 + 0.25 * j) + rng.normal(0, 25, size=shape).astype(np.float32)
            out = os.path.join(root, "BPH-PCA", "BPH", m)
            os.makedirs(out, exist_ok=True)
            write_nifti(vol.astype(np.int16), os.path.join(out, f"{case}.nii.gz"))
        out = os.path.join(root, "BPH-PCA", "ROI(BPH+PCA)", "BPH")
        os.makedirs(out, exist_ok=True)
        write_nifti(label, os.path.join(out, f"{case}.nii.gz"))


def expected_train_launches(config, steps: int, eval_forwards: int):
    """(B1, B2) launches of ``steps`` optimizer steps and ``eval_forwards``
    validation forwards: per microbatch 18 forward (18 more recomputed under
    remat) and 17 dx convs on B1, 18 dW on B2; 18 B1 per eval forward."""
    micro = config.accum_steps
    b1_step = micro * (18 + 17 + (18 if config.remat else 0))
    return steps * b1_step + 18 * eval_forwards, steps * micro * 18


def train(work: str, device, card: str):
    """The port's training path: ``Trainer(config).train()`` for 2 epochs on
    5 synthetic 128^3 cases in the flagship configuration, then a run killed
    after epoch 1 and resumed, then one case served from ``best.pth``.
    Returns the kernel launches counted during the first run."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "train_data")
    t0 = time.perf_counter()
    config = get_config(base_features=BASE_FEATURES, data_dir=data, save_dir=os.path.join(work, "ckpt_a"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, **TRAIN)
    write_train_tree(data, config.modalities, TRAIN_CASES)
    log(f"train setup ({TRAIN_CASES} synthetic 128^3 cases written) {time.perf_counter() - t0:.1f} s")

    trainer = Trainer(config, device=device)
    if len(trainer.train_indices) != 4 or len(trainer.val_indices) != 1:
        raise AssertionError(f"split {trainer.train_indices} / {trainer.val_indices}")
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (conv3d.launches, conv3d_grad.launches)
    want = expected_train_launches(config, steps=2, eval_forwards=2)
    log(f"trained 2 epochs in {wall:.1f} s (first epoch cold, checkpoints included): history "
        f"{json.dumps(history)}; launches B1 {launches[0]}, B2 {launches[1]} (expected {want}) [{card}]")
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"non-finite history {history}")
    for name in ("latest", "best"):
        if not os.path.isfile(train_checkpoint_path(config.save_dir, name)):
            raise AssertionError(f"no {name} checkpoint")

    # killed after epoch 1, resumed: epoch 2 again, from the checkpoint
    killed = config.replace(save_dir=os.path.join(work, "ckpt_b"), num_epochs=1)
    Trainer(killed, device=device).train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device=device)
    if resumed.start_epoch != 1:
        raise AssertionError(f"resumed at epoch {resumed.start_epoch}")
    again = resumed.train()
    same_params = all(torch.equal(a, b) for a, b in zip(trainer.state.model.state_dict().values(),
                                                      resumed.state.model.state_dict().values()))
    log(f"resume from latest after epoch 1: history {json.dumps(again)}; bitwise equal to the "
        f"uninterrupted run: history {again == history}, params {same_params} [{card}]")
    # every op of the step is deterministic on the card (the kernels' split-K
    # partials and every reduction are summed in a fixed order; no atomics)
    if again != history or not same_params:
        raise AssertionError("the resumed run differs from the uninterrupted one")
    del trainer, resumed
    torch.cuda.empty_cache()

    # serve one case from the best model's reference-layout .pth
    predictor = Predictor(get_config(base_features=BASE_FEATURES), os.path.join(config.save_dir, "best.pth"),
                          device=device)
    case = os.path.join(work, "serve_case")
    for m in config.modalities:
        os.makedirs(os.path.join(case, m))
        shutil.copy(os.path.join(data, "BPH-PCA", "BPH", m, "case000.nii.gz"), os.path.join(case, m, "t.nii.gz"))
    out = predictor.predict_and_save(case, os.path.join(work, "served", "segmentation.nii.gz"))
    from pcmseg_tpu_torch.data.io import read_volume

    mask = read_volume(out).data
    if mask.dtype != np.uint8 or mask.shape != TRAIN["target_size"]:
        raise AssertionError(f"served mask {mask.dtype} {mask.shape}")
    log(f"served case000 from best.pth: mask {mask.shape}, foreground {mask.mean():.4f}")
    del predictor
    torch.cuda.empty_cache()
    return launches


def time_steps(device, card: str) -> None:
    """Median warm train-step time at the flagship configuration on one
    synthetic device batch, kernel path and plain conv, peak device memory;
    the launch counts of one step with remat on; the device time of one
    kernel step by kernel (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    g = torch.Generator(device=device).manual_seed(7)
    n = TRAIN["batch_size"]
    batch = {"image": torch.randn((n, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16),
             "label": blob_label((SIZE,) * 3, device)[None].expand(n, -1, -1, -1, -1).contiguous()}
    results = {}
    for remat in (False, True):
        config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "remat": remat})
        model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
        state = create_train_state(model, config)
        step = make_train_step(model, config)
        conv3d.launches = conv3d_grad.launches = 0
        float(step(state, batch)["loss"])
        want = expected_train_launches(config, steps=1, eval_forwards=0)
        if (conv3d.launches, conv3d_grad.launches) != want:
            raise AssertionError(f"remat={remat}: one step launched {(conv3d.launches, conv3d_grad.launches)}, "
                                 f"expected {want}")
        arms = (("kernel", None), ("plain", torch.bfloat16), ("kernel", None)) if not remat else (("kernel", None),)
        for arm, dtype in arms:
            ctx = plain_train_conv(model, dtype) if dtype else contextlib.nullcontext()
            with ctx:
                float(step(state, batch)["loss"])  # warm
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(TIME_STEPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    float(step(state, batch)["loss"])
                    times.append(time.perf_counter() - t)
                peak = torch.cuda.max_memory_allocated() / 2**30
            med = sorted(times)[len(times) // 2]
            results.setdefault((arm, remat), []).append(med)
            log(f"train step remat={remat} {arm}: median {med * 1e3:.1f} ms of {TIME_STEPS} = {n / med:.3f} vol/s, "
                f"peak device memory {peak:.2f} GiB [{card}]")
        if not remat:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                float(step(state, batch)["loss"])
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    row = by_name.setdefault(e.name, [0.0, 0])
                    row[0] += e.time_range.end - e.time_range.start
                    row[1] += 1
            total = sum(us for us, _ in by_name.values())
            groups = {"B1 (forward + dx)": ("conv3x3x3", "splitk_epilogue"), "B2 (dW)": ("conv3x3_dw", "dw_reduce")}
            parts = {k: sum(us for name, (us, _) in by_name.items() if any(p in name for p in pats))
                     for k, pats in groups.items()}
            log(f"profile, one kernel step (remat off): device time {total / 1e3:.1f} ms, of which "
                + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in parts.items())
                + f", other {(total - sum(parts.values())) / 1e3:.1f} ms [{card}]")
            for us, count, name in sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)[:14]:
                log(f"  {us / 1e3:8.3f} ms  {count:4d}x  {name[:100]}")
        del model, state, step
        torch.cuda.empty_cache()
    k = results[("kernel", False)]
    log(f"flagship step (batch 4 = 4 x 1, remat off): kernel {min(k) * 1e3:.1f}-{max(k) * 1e3:.1f} ms, "
        f"plain conv {results[('plain', False)][0] * 1e3:.1f} ms; remat on kernel "
        f"{results[('kernel', True)][0] * 1e3:.1f} ms [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "pcmseg_tpu_torch", "csrc")):
        print(f"chip_smoke: no pcmseg_tpu_torch package beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data.native import get_native_lib
    from pcmseg_tpu_torch.ops.kernels import build

    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_label()
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}); nvidia-smi: {card}")

    info = build.build()
    log(f"build: {'cached' if info['cached'] else 'compiled'} {info['path']} "
        f"in {info['seconds']:.1f} s")

    config = get_config(base_features=BASE_FEATURES, norm_layer="batch")
    record = check_kernels(device, card, (1, config.window_tile_batch))
    dx = check_dx_kernels(device, card)
    dw = check_dw_kernels(device, card)
    check_gradients(device, card)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    train_launches = train(work, device, card)
    time_steps(device, card)

    native = get_native_lib() is not None
    log(f"host preprocessing: {'native C++ normalize' if native else 'numpy fallback'}")
    serve_launches, server = serve(work, config, device, card)
    profile(work, server, card)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [
        {
            "name": "conv3x3x3",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3x3.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d.py:121",
            "launches": train_launches[0],
            "launches_by_path": {"train": train_launches[0], "serve": serve_launches},
            "max_abs_err": max(record["max_abs_err"], dx["max_abs_err"]),
            # the 18 forward convs of one 128^3 microbatch; dx_*: the 17 dx convs
            **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"dx_{k}": dx[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        },
        {
            "name": "conv3x3_dw",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3_dw.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d_grad.py:147",
            "launches": train_launches[1],
            "launches_by_path": {"train": train_launches[1]},
            **dw,
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
