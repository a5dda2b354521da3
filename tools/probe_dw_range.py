"""Where the fp16 conv kernels lose accuracy on inputs that span many binades.

    python tools/probe_dw_range.py [--out DIR]
    python tools/probe_dw_range.py --device cpu --base 4 --size 16   # a rehearsal with the plain versions

On one NVIDIA GPU: builds the kernels, runs the fp16 flagship step as
``chip_smoke.py``'s fp16 phase runs it (base 64, 128^3, the dp batches,
the model from seed 0, 3 steps and the profiled fourth), and records each
conv's x and dy in one microbatch's backward with ``chip_smoke.conv_io``.
Then:

  * every conv: its Function's dW (B2) against a float64 weight gradient of
    the same fp16 x and dy, per element over Σ|x·dy|, beside dy's share of
    zeros and fp16 subnormals and the binades its nonzero entries span;
  * the deepest level's convs (8^3 at 128^3) in detail, and synthetic fp16
    inputs at 512->1024 and 1024->1024 @8^3 and 256->512 @16^3 whose dy is
    |normal|·2^-U, U uniform in [0, 26], same-sign and mixed-sign: B2, B2
    on dy·2^k (k puts max|dy| in [2^14, 2^15); exact in fp16, and dW·2^-k
    exact in fp32), B2 with dy's subnormals set to 0, cuBLAS's fp16 GEMM
    with fp32 output per tap and cuDNN's fp16 weight gradient (rounded to
    fp16), the plain fp32 version, and an emulation of the kernel's sums
    (``emulate``: exact k4 sums truncated into an fp32 accumulator, the
    model of ``tests/test_torch_dw_chains.py``), each against float64;
    where the worst elements lie and how much of their Σ|x·dy| comes from
    subnormal dy; B1 as dx on the same dy (also with the weight scaled up
    so that dx lands in fp16's normal range) and as the forward on x, in
    units of the fp16 output's last place (fp16's least subnormal, 2^-24,
    below 2^-14), with and without the rescale;
  * first, cuBLAS's fp16 GEMM with fp32 output on single products and sums
    of 16 equal products at every magnitude, and on two products 4·dy +
    (1 + 2^-10)·2^-i·dy with a subnormal and a normal dy (``product_floor``):
    which bits of fp16 products the tensor cores keep.

The 8^3 layers' x and dy are saved to DIR (default build/dw_range).
Prints the card's name and power limit. Imports no JAX.
"""
import argparse
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad  # noqa: E402

F16_NORMAL = cs.F16_NORMAL
TAP_CLASS = ("centre", "face", "edge", "corner")


def log(msg: str) -> None:
    print(msg, flush=True)


def flush(t):
    """``t`` with its fp16 subnormals set to 0."""
    return torch.where(t.abs() < F16_NORMAL, torch.zeros_like(t), t)


def rescale_exponent(dy) -> int:
    """One k for the whole of dy (max|dy|·2^k in [2^14, 2^15)), by the rule
    the fp16 kernel applies to each tensor-core chain's max|dy|."""
    return conv3d_grad.f16_scale_exponent(dy.abs().max().item())


def describe(t, what: str) -> str:
    a = t.abs().double()
    nz = a[a > 0]
    zeros, sub = (a == 0).double().mean().item(), ((a > 0) & (a < F16_NORMAL)).double().mean().item()
    if nz.numel() == 0:
        return f"{what}: all zero"
    lo, hi = math.log2(nz.min().item()), math.log2(nz.max().item())
    return (f"{what}: {zeros:.4f} zero, {sub:.4f} subnormal (0 < |v| < 2^-14), nonzero |v| in "
            f"[2^{lo:.1f}, 2^{hi:.1f}] ({hi - lo:.1f} binades)")


def dw64(x, dy):
    return conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())


def rel_err(got, exact, scale) -> tuple:
    e = (got.double() - exact).abs() / scale
    return e.max().item(), e.mean().item(), e


def kernel_order(t, tile=conv3d_grad.DW_TILE):
    """(N, D, H, W, C) -> (voxels, C) in B2's K order: tiles (n, z, y, x), in
    a tile k16 step j = 4 zz + q holds rows 2q, 2q + 1 (r) of z plane zz,
    K = 8 r + x."""
    n, d, h, w, c = t.shape
    tz, ty, tx = tile
    t = t.reshape(n, d // tz, tz, h // ty, ty // 2, 2, w // tx, tx, c)
    return t.permute(0, 1, 3, 6, 2, 4, 5, 7, 8).reshape(-1, c)


def emulate(x, dy, group: int = 4):
    """B2's sums of fp16 x, dy (N = 1) as ``tests/test_torch_dw_chains.py``
    models them: per tap, exact sums of ``group`` consecutive products in K
    order added to an fp32 accumulator rounding toward zero, a fresh
    accumulator every chain_steps k16 steps added to its split's fp32
    running total (nearest), the split partials added in split order.
    Returns (3, 3, 3, Ci, Co) fp32."""
    _, d, h, w, ci = x.shape
    co = dy.shape[-1]
    plan = conv3d_grad.dw_plan(1, d, h, w, ci, co, 132)
    per_chain = plan["chain_steps"] * 16 // group
    per_split = plan["tiles_per_split"] * conv3d_grad.DW_STEPS_PER_TILE * 16 // group
    # whole tiles: zeros past the volume's end add nothing, as TMA's zero fill
    tz, ty, tx = conv3d_grad.DW_TILE
    pd, ph, pw = -d % tz, -h % ty, -w % tx
    d, h, w = d + pd, h + ph, w + pw
    xp = F.pad(x.double(), (0, 0, 1, 1 + pw, 1, 1 + ph, 1, 1 + pd))
    dk = kernel_order(F.pad(dy.double(), (0, 0, 0, pw, 0, ph, 0, pd))).reshape(-1, group, co)
    out = torch.empty((27, ci, co), dtype=torch.float32, device=x.device)
    for tap in range(27):
        kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
        xk = kernel_order(xp[:, kd:kd + d, kh:kh + h, kw:kw + w]).reshape(-1, group, ci)
        out[tap] = 0
        for s0 in range(0, xk.shape[0], per_split):
            total = torch.zeros((ci, co), dtype=torch.float32, device=x.device)
            acc = torch.zeros_like(total)
            end = min(xk.shape[0], s0 + per_split)
            for g in range(s0, end):
                s = acc.double() + xk[g].T @ dk[g]
                f = s.float()
                past = f.double().abs() > s.abs()
                acc = torch.where(past, torch.nextafter(f, torch.zeros_like(f)), f)
                if (g + 1 - s0) % per_chain == 0 or g + 1 == end:
                    total, acc = total + acc, torch.zeros_like(acc)
            out[tap] += total
    return out.reshape(3, 3, 3, ci, co)


def cublas_dw(x, dy):
    """Per tap, cuBLAS's fp16 GEMM with fp32 output (``torch.mm(...,
    out_dtype=float32)``) of the shifted x and dy; None where unsupported."""
    _, d, h, w, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    dyf = dy.reshape(-1, dy.shape[-1])
    try:
        taps = [torch.mm(xp[:, kd:kd + d, kh:kh + h, kw:kw + w].reshape(-1, ci).T.contiguous(), dyf,
                         out_dtype=torch.float32)
                for kd in range(3) for kh in range(3) for kw in range(3)]
    except (RuntimeError, TypeError) as e:
        log(f"  cuBLAS fp16 GEMM with fp32 output: not available ({str(e).splitlines()[0][:100]})")
        return None
    return torch.stack(taps).reshape(3, 3, 3, ci, dy.shape[-1])


def ulps(got, exact, scale: float = 1.0) -> tuple:
    """An fp16 output ``got`` against the float64 ``exact``·scale, in units of
    the fp16 output's last place (2^-24 below 2^-14): (max |off|, mean off,
    share not the correctly rounded value, outputs that overflowed)."""
    want = exact * scale
    finite = torch.isfinite(got) & (want.abs() <= 65504)
    off = ((got.double() - want) / cs.fp16_unit(want))[finite]
    wrong = (got != want.half())[finite].double().mean().item()
    return off.abs().max().item(), off.mean().item(), wrong, int((~finite).sum())


def b2_study(x, dy, what: str, fn_dw=None) -> dict:
    """B2 and its yardsticks on fp16 x, dy, each against float64 over Σ|x·dy|."""
    exact = dw64(x, dy)
    scale = dw64(x.abs(), dy.abs()).clamp_min(1e-300)
    res = {}
    got = conv3d_grad.conv3x3_dw(x, dy)
    res["B2"] = rel_err(got, exact, scale)
    if fn_dw is not None:
        log(f"  {what}: the Function's dW bitwise equal to B2 rerun on the recorded x, dy: "
            f"{torch.equal(fn_dw, got)}")
    k = rescale_exponent(dy)
    dyk = (dy.float() * 2.0**k).half()
    exact_scaled = bool((dyk.double() == dy.double() * 2.0**k).all())
    scaled = conv3d_grad.conv3x3_dw(x, dyk) * 2.0**-k
    res[f"B2 on dy·2^{k}"] = rel_err(scaled, exact, scale)
    sub_dy = bool(((dyk != 0) & (dyk.abs() < F16_NORMAL)).any())
    flushed = conv3d_grad.conv3x3_dw(x, flush(dy))
    res["B2, dy's subnormals set to 0"] = rel_err(flushed, exact, scale)
    res["plain fp32"] = rel_err(conv3d_grad.conv3x3_dw_reference(x.float(), dy.float()), exact, scale)
    if x.is_cuda:
        cb = cublas_dw(x, dy)
        if cb is not None:
            res["cuBLAS fp16 GEMM, fp32 out"] = rel_err(cb, exact, scale)
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        cd = torch.nn.grad.conv3d_weight(xc, (dy.shape[-1], x.shape[-1], 3, 3, 3), dyc, padding=1)
        cd = cd.permute(2, 3, 4, 1, 0)
        res["cuDNN fp16 wgrad (fp16 out)"] = rel_err(cd, exact, scale)
        log(f"  {what}: cuDNN fp16 wgrad from fp16(float64): {ulps(cd, exact)[0]:.3g} fp16 ulps at most")
    emu = emulate(x, dy)
    res["emulation (k4 sums truncated)"] = rel_err(emu, exact, scale)
    res["emulation (k16 sums truncated)"] = rel_err(emulate(x, dy, 16), exact, scale)
    log(f"  {what}: B2 on dy·2^{k} exact in fp16 {exact_scaled}, subnormals left after it {sub_dy}; "
        f"bitwise equal to B2: on dy·2^{k} scaled back {torch.equal(scaled, got)}, with dy's subnormals set to 0 "
        f"{torch.equal(flushed, got)}; B2 equal to the k4 emulation on "
        f"{(emu == got).double().mean().item():.4f} of the elements, max |B2 - emulation| "
        f"{((got.double() - emu.double()).abs() / scale).max().item():.3g}·Σ|x·dy|")
    for name, (mx, mean, _) in res.items():
        log(f"  {what}: {name}: max {mx:.3g}, mean {mean:.3g} ·Σ|x·dy| from float64")
    # where B2's worst elements lie
    err = res["B2"][2]
    sub_part = dw64(x.abs(), dy.abs() * ((dy != 0) & (dy.abs() < F16_NORMAL))) / scale
    flat = err.flatten().topk(5)
    for v, i in zip(flat.values.tolist(), flat.indices.tolist()):
        tap, rest = divmod(i, x.shape[-1] * dy.shape[-1])
        ci, co = divmod(rest, dy.shape[-1])
        kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
        cls = TAP_CLASS[(kd != 1) + (kh != 1) + (kw != 1)]
        e = (kd, kh, kw, ci, co)
        col = dy[..., co]
        log(f"  {what}: worst {v:.3g} at tap {tap} ({cls}) ci {ci} co {co}: Σ|x·dy| {scale[e].item():.3g}, "
            f"|dW|/Σ|x·dy| {(exact[e].abs() / scale[e]).item():.3g}, share of Σ|x·dy| from subnormal dy "
            f"{sub_part[e].item():.3g}; dy[..., co]: {((col != 0) & (col.abs() < F16_NORMAL)).double().mean().item():.3f}"
            f" subnormal, {(col == 0).double().mean().item():.3f} zero")
    low = sub_part < 1e-9
    log(f"  {what}: B2's max error over elements with no subnormal-dy share {err[low].max().item() if low.any() else 0:.3g}"
        f" ({low.double().mean().item():.3f} of them), with one {err[~low].max().item() if (~low).any() else 0:.3g}")
    return {n: r[0] for n, r in res.items()}


def b1_study(x, dy, weight, what: str) -> None:
    """B1 as dx on dy and as the forward on x, against float64 in fp16 ulps,
    with and without dy·2^k."""
    w_t = conv3d.pack_weight(weight.flip(2, 3, 4).transpose(0, 1), torch.float16)
    exact = conv3d.conv3x3x3_reference(dy.double(), w_t.double(), None, False)
    # Σ|w·dy| of each output: the scale of its fp32 sum's rounding, as Σ|x·dy| for dW
    scale = conv3d.conv3x3x3_reference(dy.double().abs(), w_t.double().abs(), None, False).clamp_min(1e-300)
    k = rescale_exponent(dy)
    plain = None
    for label, inp, s in (("dx", dy, 1.0), (f"dx on dy·2^{k}", (dy.float() * 2.0**k).half(), 2.0**k),
                          ("dx, dy's subnormals set to 0", flush(dy), 1.0)):
        got = conv3d.conv3x3x3(inp, w_t, None, False)
        if plain is None:
            plain = got
        else:  # where both outputs are normal fp16, an exact sum scaled by 2^k rounds to the same bits
            both = (exact.abs() >= F16_NORMAL) & ((exact * s).abs() <= 32768)
            same = (got.double() / s == plain.double())[both].double().mean().item()
            log(f"  {what}: B1 {label}: {same:.6f} of the outputs normal both ways equal B1 dx bit for bit "
                "once scaled back")
        mx, mean, wrong, inf = ulps(got, exact, s)
        # below 2^-14 (scaled) fp16's own spacing, 2^-24, dominates: the
        # sum's error over Σ|w·dy| where the output is normal
        normal = (exact * s).abs() >= F16_NORMAL
        over = ((got.double() / s - exact).abs() / scale)[normal & torch.isfinite(got)]
        log(f"  {what}: B1 {label}: max {mx:.3g} ulp, mean {mean:.3g} ulp, {wrong:.4f} not correctly rounded, "
            f"{inf} past 65504; normal outputs' error max {over.max().item() if over.numel() else 0:.3g}·Σ|w·dy|; "
            f"{describe(exact * s, 'float64 dx')}")
    # the weight scaled up by a power of two so that dx on this dy lands in
    # fp16's normal range, where a loss in the sums shows after the rounding
    s = rescale_exponent(w_t.abs().max().reshape(1))
    w_s = (w_t.double() * 2.0**s).to(torch.float16)
    exact_s = conv3d.conv3x3x3_reference(dy.double(), w_s.double(), None, False)
    got = conv3d.conv3x3x3(dy, w_s, None, False)
    mx, mean, wrong, inf = ulps(got, exact_s)
    normal = exact_s.abs() >= F16_NORMAL
    log(f"  {what}: B1 dx with the weight·2^{s}: max {mx:.3g} ulp, mean {mean:.3g} ulp, {wrong:.4f} not correctly "
        f"rounded ({normal.double().mean().item():.3f} of the outputs normal; of those "
        f"{(got != exact_s.half())[normal].double().mean().item():.4f} not correctly rounded), {inf} past 65504")
    packed = conv3d.pack_weight(weight, torch.float16)
    got = conv3d.conv3x3x3(x, packed, None, False)
    mx, mean, wrong, _ = ulps(got, conv3d.conv3x3x3_reference(x.double(), packed.double(), None, False))
    log(f"  {what}: B1 forward: max {mx:.3g} ulp, mean {mean:.3g} ulp, {wrong:.4f} not correctly rounded")


def product_floor(device) -> None:
    """Which fp16 products the tensor cores keep in an fp32 sum, through
    cuBLAS's fp16 GEMM with fp32 output (no kernel of the repository in
    between): C = A·B with K = 16, row i of A holding one x = 2^-a, column
    j of B one dy = 3·2^-(b+1) (two significant bits, a subnormal below
    2^-14), so that C[i, j] is one product 3·2^-(a+b+1); then sums of 16
    equal products. Logs, for each product exponent, whether every product
    and every sum came out exact, and the worst relative error."""
    f16 = torch.float16
    exps = torch.arange(25, device=device, dtype=torch.float64)
    a = torch.zeros((25, 16), dtype=torch.float64, device=device)
    a[:, 0] = torch.exp2(-exps)
    b = torch.zeros((16, 25), dtype=torch.float64, device=device)
    b[0, :] = 3 * torch.exp2(-exps - 1)
    try:
        got = torch.mm(a.to(f16), b.to(f16), out_dtype=torch.float32).double()
    except (RuntimeError, TypeError) as e:
        log(f"product floor: cuBLAS fp16 GEMM with fp32 output not available ({str(e).splitlines()[0][:100]})")
        return
    want = a.to(f16).double() @ b.to(f16).double()
    rel = ((got - want).abs() / want.abs().clamp_min(1e-300))
    t = (exps[:, None] + exps[None, :] + 1)  # product = 3·2^-(t)
    for lo in range(0, 50, 4):
        sel = (t >= lo) & (t < lo + 4)
        if sel.any():
            log(f"product floor: single products 3·2^-t, t in [{lo}, {lo + 4}): max relative error "
                f"{rel[sel].max().item():.3g}, {(rel[sel] > 0).double().mean().item():.3f} of them inexact")
    # two products in one sum, x = 4 and x = (1 + 2^-10)·2^-i, both times the
    # same dy: 2^-24 (subnormal) or 2^-4 (normal; the same sums times 2^20)
    pair = torch.zeros((15, 16), dtype=torch.float64, device=device)
    pair[:, 0] = 4.0
    pair[:, 1] = (1 + 2.0**-10) * torch.exp2(-torch.arange(15, device=device, dtype=torch.float64))
    both = torch.zeros((16, 2), dtype=torch.float64, device=device)
    both[:2, 0], both[:2, 1] = 2.0**-24, 2.0**-4
    got = torch.mm(pair.to(f16), both.to(f16), out_dtype=torch.float32).double()
    want = pair @ both
    for col, label in ((0, "dy = 2^-24 (subnormal)"), (1, "dy = 2^-4 (normal)")):
        lost = ((want[:, col] - got[:, col]) / want[:, col]).tolist()
        log(f"product floor: 4·dy + (1 + 2^-10)·2^-i·dy, {label}: relative error for i = 0..14 "
            f"{[f'{v:.3g}' for v in lost]}")
    # 16 equal products x·dy in one K = 16 sum
    a16 = torch.exp2(-exps)[:, None].expand(25, 16).to(f16)
    b16 = (3 * torch.exp2(-exps - 1))[None, :].expand(16, 25).to(f16)
    got = torch.mm(a16.contiguous(), b16.contiguous(), out_dtype=torch.float32).double()
    want = a16.double() @ b16.double()
    rel = ((got - want).abs() / want.abs().clamp_min(1e-300))
    for lo in range(0, 50, 4):
        sel = (t >= lo) & (t < lo + 4)
        if sel.any():
            log(f"product floor: sums of 16 products 3·2^-t, t in [{lo}, {lo + 4}): max relative error "
                f"{rel[sel].max().item():.3g}, {(rel[sel] > 0).double().mean().item():.3f} of them inexact")


def batches(device, size: int):
    """``chip_smoke.dp_batches`` at a cubic ``size`` (equal to it at 128)."""
    g = torch.Generator(device=device).manual_seed(cs.DP_SEED)
    n = cs.TRAIN["batch_size"]
    label = cs.blob_label((size,) * 3, device)
    return [{"image": torch.randn((n, size, size, size, 5), generator=g, device=device).to(torch.bfloat16),
             "label": torch.stack([label.roll(8 * i, 1) for i in range(n)])} for _ in range(cs.DP_STEPS)]


def capture(device, base: int, size: int):
    """The fp16 phase's step sequence; returns (model, conv_io records, grads)."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    config = get_config(base_features=base, **{**cs.TRAIN, "compute_dtype": "float16", "target_size": (size,) * 3})
    data = batches(device, size)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    for batch in data + data[-1:]:  # 3 steps and the profiled one
        step(state, batch)
    model.zero_grad(set_to_none=True)
    with cs.conv_io(model) as records:
        loss_fn_from_config(config)(model(data[0]["image"][:1]), data[0]["label"][:1]).backward()
    grads = {k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None}
    return model, records, grads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--base", type=int, default=cs.BASE_FEATURES)
    ap.add_argument("--size", type=int, default=cs.SIZE)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "dw_range"))
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("probe_dw_range: no CUDA device (--device cpu rehearses with the plain versions)")
        from pcmseg_tpu_torch.ops.kernels import build

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"build: {build.build()}")
    if device.type == "cuda":
        product_floor(device)
    model, records, grads = capture(device, args.base, args.size)
    deepest = min(r["x"].shape[1] for r in records.values())
    saved = {}
    for name, rec in records.items():
        x, dy = rec["x"], rec["dy"]
        exact = dw64(x, dy)
        scale = dw64(x.abs(), dy.abs()).clamp_min(1e-300)
        fn_dw = grads[name + ".weight"].permute(2, 3, 4, 1, 0)
        mx, mean, _ = rel_err(fn_dw, exact, scale)
        log(f"{name} {x.shape[-1]}->{dy.shape[-1]} @{x.shape[1]}^3: the Function's dW max {mx:.3g}, mean {mean:.3g}"
            f" ·Σ|x·dy| from float64; {describe(dy, 'dy')}; {describe(x, 'x')}")
        if x.shape[1] == deepest:
            saved[name] = {"x": x.cpu(), "dy": dy.cpu()}
    for name, rec in records.items():
        if name not in saved:
            continue
        x, dy = rec["x"], rec["dy"]
        what = f"{name} {x.shape[-1]}->{dy.shape[-1]} @{x.shape[1]}^3 (captured)"
        log(f"{what}:")
        b2_study(x, dy, what, grads[name + ".weight"].permute(2, 3, 4, 1, 0))
        b1_study(x, dy, model.get_submodule(name).weight.detach().float(), what)
    os.makedirs(args.out, exist_ok=True)
    torch.save(saved, os.path.join(args.out, f"captured_{deepest}.pt"))
    log(f"saved {sorted(saved)} to {args.out}")
    del model, records, grads

    g = torch.Generator(device=device).manual_seed(3)
    shapes = ((512, 1024, 8), (1024, 1024, 8), (256, 512, 16))
    if device.type == "cpu":
        shapes = ((16, 16, 8), (16, 32, 16))
    for ci, co, s in shapes:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device).abs_().half()
        u = torch.rand((1, s, s, s, co), generator=g, device=device) * 26
        mag = torch.randn((1, s, s, s, co), generator=g, device=device).abs_() * torch.exp2(-u)
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * co))
        for signs in ("same-sign", "mixed-sign"):
            dy = (mag if signs == "same-sign" else mag * torch.randn(mag.shape, generator=g, device=device).sign())
            dy = dy.half()
            what = f"synthetic {ci}->{co} @{s}^3, {signs} dy = |normal|·2^-U"
            log(f"{what}: {describe(dy, 'dy')}")
            b2_study(x, dy, what)
            b1_study(x, dy, w, what)
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
