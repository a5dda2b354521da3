"""Quick check of the port's conv kernels on one NVIDIA GPU, for kernel work.

    python tools/probe_torch_kernels.py [--ptxas] [--time] [--f32 | --f16]

Builds the kernels (with --ptxas, first prints each source's registers,
spills and warnings from ``nvcc -Xptxas -v``, and with --f32 the fp32
kernels' dynamic shared memory a block), checks B1 and B2 against
their plain versions at small and ragged shapes that cover every code path
(the 8-channel input path, split K over clusters of 2 to 8 blocks,
slices that start and end inside a chunk, slices of K cut into chains, split
and persistent, partial tiles, Co below one N tile), each B1 and B2 launch twice and bitwise equal, and on a failure
names the taps that are wrong alone. A watchdog ends the
process if the card does not finish a kernel within 30 s, so that a hung
kernel fails the run instead of holding the card. With --time, times
forward and weight gradient at 7 of the model's shapes, each with its share
of the card's bound for its operands (bf16: 989 TFLOP/s; fp32: 3xTF32,
494.7 / 3 TFLOP/s) and beside cuDNN's weight gradient, prints the weight
gradient's relative error from float64 on same-sign inputs (the loss of
its fp32 sums) with the 16-bit kernel's chain length and splits
(``conv3d_grad.dw_plan``), and prints the card's name and power limit. With --f32,
the fp32 kernels instead of the bf16 ones, each held against a float64 conv
of the same fp32 inputs: its error at most twice cuDNN's fp32 error (TF32
off) plus 1e-6 of the largest output. With --f16, the fp16 kernels, held
against an fp32 conv of the same fp16 inputs within the bf16 bounds scaled by
the unit roundoffs (2^-11 against 2^-8), and at outputs and inputs in fp16's
subnormal range and past its largest value: subnormals kept (not flushed to
zero), ±inf where the fp32 result rounds past 65504. The last line is ALL OK
or SOME FAILED.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from pcmseg_tpu_torch.ops.kernels import build, conv3d, conv3d_grad  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probe_torch_kernels: no CUDA device; the kernels run only on an NVIDIA GPU")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
F32 = "--f32" in sys.argv
F16 = "--f16" in sys.argv
DT = torch.float32 if F32 else torch.float16 if F16 else torch.bfloat16
# the 16-bit bounds, relative: fp16's unit roundoff 2^-11 is 1/8 of bf16's 2^-8
REL = 1 / 8 if F16 else 1.0


def sync(label, limit=30.0):
    ev = torch.cuda.Event()
    ev.record()
    t = time.time()
    while not ev.query():
        if time.time() - t > limit:
            print(f"HANG in {label}", flush=True)
            os._exit(3)
        time.sleep(0.0005)


def log(*a):
    print(*a, flush=True)


if "--ptxas" in sys.argv:
    for src in sorted(build.CSRC_DIR.glob("*.cu")):
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull, str(src)],
                           capture_output=True, text=True)
        log(src.name, "rc", r.returncode)
        log("\n".join(l for l in (r.stdout + r.stderr).splitlines()
                       if "ptxas" in l or "spill" in l or "error" in l or "warning" in l)[-5000:])
t0 = time.time()
log(build.build(), f"{time.time() - t0:.1f}s")
if F32 and "--ptxas" in sys.argv:  # the fp32 kernels' dynamic shared memory (ptxas shows static only)
    lib = build.load_library()
    for ci, co in ((8, 64), (64, 64), (64, 128)):
        log(f"B1 fp32 Ci={ci} Co={co}: {lib.pcmseg_conv3x3x3_f32_smem_bytes(ci, co)} bytes of shared memory a block")
    for ci in (8, 64):
        log(f"B2 fp32 Ci={ci}: {lib.pcmseg_conv3x3_dw_f32_smem_bytes(ci)} bytes of shared memory a block")


def b1_check(n, sp, ci, co, relu=True, label="", diag=True):
    g = torch.Generator(device=dev).manual_seed(ci * 7 + co)
    x = torch.randn((n, *sp, ci), generator=g, device=dev).to(DT)
    w = torch.randn((co, ci, 3, 3, 3), generator=g, device=dev) * (2.0 / (27 * ci)) ** 0.5
    b = torch.randn((co,), generator=g, device=dev) * 0.1
    packed = conv3d.pack_weight(w, DT)
    got = conv3d.conv3x3x3(x, packed, b, relu)
    again = conv3d.conv3x3x3(x, packed, b, relu)
    sync(f"B1 {label}")
    if F32:
        ref = conv3d.conv3x3x3_reference(x.double(), packed.double(), b, relu)
        plain = (conv3d.conv3x3x3_reference(x, packed, b, relu).double() - ref).abs().max()
        err = (got.double() - ref).abs()
        bound = 2 * plain + 1e-6 * ref.abs().max()
    else:
        ref = conv3d.conv3x3x3_reference(x.float(), packed.float(), b, relu)
        err = (got.float() - ref).abs()
        bound = REL * (8e-3 * ref.abs() + 1e-3 * ref.abs().max())
    bad = err > bound
    ok = bool(torch.isfinite(got).all()) and not bool(bad.any()) and torch.equal(got, again)
    log(f"B1 {label} n={n} {sp} {ci}->{co} relu={relu}: {'OK' if ok else 'FAIL'} max_err {err.max().item():.4g} "
        f"worst err/bound {(err / bound).max().item():.3g} bad {bad.float().mean().item():.4f} "
        f"finite {bool(torch.isfinite(got).all())} bitwise {torch.equal(got, again)}")
    if not ok and diag:
        idx = bad.nonzero()[:5].tolist()
        log("  first bad (n,z,y,x,c):", idx)
        # which taps are wrong: weight at one tap only
        wrong = []
        for tap in range(27):
            wt = torch.zeros_like(w)
            kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
            wt[:, :, kd, kh, kw] = w[:, :, kd, kh, kw]
            pk = conv3d.pack_weight(wt, DT)
            got_t = conv3d.conv3x3x3(x, pk, None, False)
            sync(f"B1 diag tap {tap}")
            ref_t = conv3d.conv3x3x3_reference(x.double(), pk.double(), None, False)
            e = (got_t.float() - ref_t).abs().max().item()
            if e > 1e-2 * ref_t.abs().max().item() + 1e-6 or not torch.isfinite(got_t).all():
                wrong.append((tap, round(e, 4)))
        log("  taps wrong alone:", wrong)
    return ok


def b2_check(n, sp, ci, co, label="", diag=True):
    g = torch.Generator(device=dev).manual_seed(ci * 3 + co)
    x = torch.randn((n, *sp, ci), generator=g, device=dev).to(DT)
    dy = torch.randn((n, *sp, co), generator=g, device=dev).to(DT)
    got = conv3d_grad.conv3x3_dw(x, dy)
    again = conv3d_grad.conv3x3_dw(x, dy)
    sync(f"B2 {label}")
    if F32:
        ref = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
        plain = (conv3d_grad.conv3x3_dw_reference(x, dy).double() - ref).abs().max().item()
        err = (got.double() - ref).abs()
        bound = 2 * plain + 1e-6 * ref.abs().max().item()
    else:
        ref = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
        err = (got - ref).abs()
        bound = REL * 2e-3 * ref.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err.max().item() <= bound and torch.equal(got, again)
    log(f"B2 {label} n={n} {sp} {ci}->{co}: {'OK' if ok else 'FAIL'} max_err {err.max().item():.4g} bound {bound:.4g} "
        f"bitwise {torch.equal(got, again)} finite {bool(torch.isfinite(got).all())}")
    if not ok and diag:
        per_tap = err.reshape(27, ci, co).amax((1, 2))
        scale = ref.abs().max().item()
        log("  taps wrong:", [(t, round(v / scale, 4)) for t, v in enumerate(per_tap.tolist()) if v > 2e-3 * scale])
        per_ci = err.amax((0, 1, 2, 4))
        log("  ci wrong:", [c for c, v in enumerate(per_ci.tolist()) if v > 2e-3 * scale][:20])
        per_co = err.amax((0, 1, 2, 3))
        log("  co wrong:", [c for c, v in enumerate(per_co.tolist()) if v > 2e-3 * scale][:20])
        log("  got[1,1,1,:2,:4]", got[1, 1, 1, :2, :4].tolist(), "ref", ref[1, 1, 1, :2, :4].tolist())
    return ok


def ms(fn, iters=10):
    fn()
    sync("warm")
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    sync("time", 120)
    return s.elapsed_time(e) / iters


results = []
B1 = [((1, (8, 8, 8), 64, 64), "general 1 chunk"), ((1, (8, 8, 8), 8, 64), "small"),
      ((1, (16, 16, 16), 5, 64), "Ci=5 padded"), ((1, (16, 16, 16), 64, 128), "bn128"),
      ((2, (9, 7, 13), 8, 24), "ragged"), ((1, (8, 8, 8), 128, 256), "split"),
      ((1, (16, 16, 16), 256, 512), "split3"), ((4, (8, 8, 8), 1024, 1024), "bottleneck"),
      ((1, (40, 37, 20), 32, 64), "ragged yx"), ((1, (5, 6, 7), 64, 8), "co8"), ((1, (5, 5, 5), 3, 136), "ci3 co136"),
      ((1, (34, 41, 47), 192, 128), "3 chunks bn128 hbuf2"), ((1, (30, 41, 47), 192, 64), "3 chunks bn64 hbuf2"),
      ((1, (32, 32, 32), 512, 256), "8 chunks hbuf2"), ((1, (8, 8, 8), 1024, 512), "6 splits across chunks"),
      ((1, (16, 16, 16), 192, 128), "3 splits"), ((1, (4, 4, 4), 2176, 64), "8 splits, chains cut in a chunk"),
      ((3, (6, 6, 6), 128, 72), "co72, two co blocks, 8 splits in 2 chunks"), ((1, (8, 8, 8), 512, 1024), "3 splits"),
      ((1, (8, 8, 8), 512, 512), "6 splits of 36 weight tiles"), ((1, (18, 32, 32), 256, 128), "persistent, 2 rounds"),
      ((1, (20, 13, 9), 512, 256), "ragged, chains cut"), ((1, (16, 16, 16), 1024, 512), "persistent, chains cut")]
for args, label in B1:
    results.append(b1_check(*args, label=label))
B2 = [((1, (8, 8, 8), 64, 64), "general"), ((1, (8, 8, 8), 8, 64), "small"), ((1, (16, 16, 16), 5, 64), "Ci=5"),
      ((2, (9, 7, 13), 8, 24), "ragged"), ((1, (5, 6, 7), 40, 16), "ci40"), ((1, (8, 8, 8), 1024, 1024), "bottleneck"),
      ((1, (32, 32, 32), 64, 64), "split"), ((2, (16, 16, 16), 256, 512), "deep")]
for args, label in B2:
    results.append(b2_check(*args, label=label))


def f16_range_checks():
    """fp16's edges: B1 outputs in the subnormal range and past 65504, B2 on
    subnormal dy. Subnormals must be kept, overflow must give ±inf."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, 8, 8, 8, 64), generator=g, device=dev).half()
    w = torch.randn((64, 64, 3, 3, 3), generator=g, device=dev) * (2.0 / (27 * 64)) ** 0.5
    oks = []
    tiny = 2.0 ** -24  # fp16's least subnormal
    for scale, label in ((2.0 ** -18, "subnormal outputs"), (2.0 ** 14, "overflowing outputs")):
        packed = conv3d.pack_weight(w * scale, torch.float16)
        got = conv3d.conv3x3x3(x, packed, None, False)
        sync(f"B1 {label}")
        ref = conv3d.conv3x3x3_reference(x.float(), packed.float(), None, False)
        want = ref.half()  # astype: round to nearest even, subnormals kept, inf past 65504
        finite = torch.isfinite(want) & torch.isfinite(got)
        err = (got.float() - want.float()).abs()[finite]
        # inf where the fp32 sum rounds past 65504; another summation order
        # may land on the other side only within a few ulps of 65520
        edge = (ref.abs() - 65520.0).abs() <= 1e-3 * 65520.0
        ok = bool((torch.isinf(got) == torch.isinf(want))[~edge].all()) and bool(
            (err <= 2 * tiny + REL * (8e-3 * want.float().abs()[finite]
                                      + 1e-3 * want.float().abs()[finite].max())).all())
        sub = (want != 0) & (want.abs() < 2.0 ** -14)
        if scale < 1:
            kept = int(((got != 0) & sub).sum())
            ok = ok and kept >= 0.99 * int(sub.sum()) > 0
            label += f" ({kept} of {int(sub.sum())} subnormal outputs kept)"
        else:
            label += f" ({int((~finite).sum())} of {want.numel()} past 65504)"
        log(f"B1 f16 {label}: {'OK' if ok else 'FAIL'} max_err {float(err.max()):.4g}")
        oks.append(ok)
    dy = (torch.randn((1, 8, 8, 8, 64), generator=g, device=dev) * 2.0 ** -18).half()
    got = conv3d_grad.conv3x3_dw(x, dy)
    sync("B2 subnormal dy")
    ref = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
    err = float((got - ref).abs().max())
    share = float(((dy != 0) & (dy.abs() < 2.0 ** -14)).float().mean())
    ok = err <= REL * 2e-3 * float(ref.abs().max()) and float(ref.abs().max()) > 0
    log(f"B2 f16 subnormal dy ({share:.3f} of dy subnormal): {'OK' if ok else 'FAIL'} max_err {err:.4g} "
        f"of max {float(ref.abs().max()):.4g}")
    return oks + [ok]


if F16:
    results += f16_range_checks()

if "--time" in sys.argv:
    peak = 494.7e12 / 3 if F32 else 989e12  # fp16 and bf16 alike
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"card: {card}")
    for ci, co, s in ((5, 64, 128), (64, 64, 128), (128, 64, 128), (128, 128, 64), (256, 256, 32), (512, 512, 16),
                      (1024, 1024, 8)):
        x = torch.randn((1, s, s, s, ci), device=dev).to(DT)
        w = torch.randn((co, ci, 3, 3, 3), device=dev) * 0.02
        packed = conv3d.pack_weight(w, DT)
        dy = torch.randn((1, s, s, s, co), device=dev).to(DT)
        flop = 2 * 27 * ci * co * s ** 3
        f = ms(lambda: conv3d.conv3x3x3(x, packed, None, True))
        d = ms(lambda: conv3d_grad.conv3x3_dw(x, dy))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        c = ms(lambda: torch.nn.grad.conv3d_weight(xc, (co, ci, 3, 3, 3), dyc, padding=1))
        least = flop / peak * 1e3
        # dW on same-sign inputs (x, dy = |normal|): every element is its own
        # sum of |x.dy|, so its relative error from float64 is what the
        # kernel's summation loses
        x.abs_()
        dy.abs_()
        ref = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
        rel = (conv3d_grad.conv3x3_dw(x, dy).double() - ref) / ref
        chains = ""
        if not F32:
            plan = conv3d_grad.dw_plan(1, s, s, s, ci, co, torch.cuda.get_device_properties(dev).multi_processor_count)
            chains = (f" (chains of {plan['chain_steps']} k16 steps; {plan['splits']} splits of "
                      f"{8 * plan['tiles_per_split']} steps)")
        log(f"time {DT} {ci}->{co}@{s}: fwd {f:.4f} ms {flop / f / 1e9:.1f} TF/s ({least / f:.3f} of the bound); "
            f"dW {d:.4f} ms {flop / d / 1e9:.1f} TF/s ({least / d:.3f} of the bound), cudnn wgrad {c:.4f} ms; "
            f"dW same-sign error from float64 max {rel.abs().max().item():.3g} mean {rel.mean().item():.3g}{chains}")
        del x, dy, xc, dyc, ref, rel
log("ALL OK" if all(results) else "SOME FAILED")
sys.exit(0 if all(results) else 1)
