#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pcmseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at the flagship model's full width and
checks every hand-written kernel on it:

  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: compiles csrc/*.cu for sm_90a with nvcc (cached by content hash
     under build/pcmseg_tpu_torch/);
  3. kernel vs plain: the 3³ conv kernel at each of the 14 distinct
     (Ci, Co, size) shapes of a 128³ base-64 forward, bf16, ReLU on and
     off, at N=1 (a whole-volume forward) and N=4 (a tiled forward's batch
     of windows), against its plain PyTorch version in fp32 from the same
     bf16 inputs, with max|kernel − ref| ≤ 8e-3·|ref| + 1e-3·max|ref| (one
     bf16 rounding plus fp32 reassociation); median CUDA-event times at N=1
     of the kernel, the plain version and cuDNN's conv alone;
  4. serve: three synthetic 5-modality NIfTI cases (two 128³, one
     160×160×144 that is tiled as 8 windows in two batches of 4) through
     ``PredictionServer.run_once`` with a seeded base-64 BatchNorm model
     (90,311,361 parameters, folded on load). Asserts 3 done, uint8 masks
     of each case's shape, and exactly 18 kernel launches per forward.
     Then, on one 128³ case and on the tiled case, the kernel's bf16
     probabilities must be no further from the same model in fp32 (plain
     conv, TF32 off) than 1.5× the distance of the plain conv's bf16
     probabilities (max and mean |dp|), and the two bf16 forwards must
     agree within PLAIN_MAX_DP / PLAIN_MEAN_DP;
  5. profile: where a warm 128³ case's time goes: host decode, device
     path and mask write each timed alone, the device path's time per
     kernel (torch.profiler), and the card's idle share over a warm
     ``run_once`` of four 128³ cases.

Every phase prints its own lines; any failure raises and exits non-zero.
Without a CUDA device, or outside a checkout of the repository, it exits 1
before doing anything. The last lines are
the kernels' JSON record, the nvidia-smi line, and the device JSON.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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

    max_err, ms, plain_ms = 0.0, 0.0, 0.0
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
        flop = 2 * 27 * ci * co * s**3 * batches[0]
        log(f"conv {ci}->{co} @{s}^3 x{layers}: ok at N={'/'.join(map(str, batches))}, "
            f"max_abs_err {shape_err:.4g}; N={batches[0]}: kernel {k_ms:.4f} ms "
            f"({flop / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, cudnn conv alone "
            f"{c_ms:.4f} ms [{card}]")
        ms += layers * k_ms
        plain_ms += layers * p_ms
        del x, w, b, packed
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def write_cases(root: str, modalities) -> None:
    """Synthetic int16 MRI-like volumes: a bright ellipsoid plus noise."""
    import numpy as np

    from pcmseg_tpu.data.nifti import write_nifti

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

    from pcmseg_tpu.data.io import read_volume
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
    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.data.native import get_native_lib
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

    native = get_native_lib() is not None
    log(f"host preprocessing: {'native C++ normalize' if native else 'numpy fallback'}")
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches, server = serve(work, config, device, card)
    profile(work, server, card)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "conv3x3x3",
        "route": "cuda",
        "source": "pcmseg_tpu_torch/csrc/conv3x3x3.cu",
        "replaces": "pcmseg_tpu/ops/pallas/conv3d.py:121",
        "launches": launches,
        **record,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
