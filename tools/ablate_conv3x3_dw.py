"""Where the 16-bit weight-gradient kernel's (B2's) time goes, on one NVIDIA GPU.

    python tools/ablate_conv3x3_dw.py [--source PATH] [--variants a,b,...] [--dtypes bf16,fp16]

Builds copies of ``pcmseg_tpu_torch/csrc/conv3x3_dw.cu`` (or of the B2
source at PATH, e.g. a parent checkout's, with its ``hopper.cuh`` beside
it) with parts of its work taken out (each copy's results are wrong: they
are timed, not checked), one nvcc process a copy, into
``build/ablate_conv3x3_dw/``, and times each in bf16 and fp16 at the 14
model shapes (N = 1), beside the share of the 16-bit bound (989 TFLOP/s)
and the sum over the 18 dW layers of one 128^3 microbatch. A time is the
card's alone: 20 launches captured in one CUDA graph, the graph replayed
5 times between two CUDA events, per launch.

  base       the kernel as it is;
  no_absmax  fp16: the pass over dy before the kernel (memset and
             f16_absmax) left out, where the source has one;
  no_scale   fp16: the scaling warps' work left out (their reads of each
             tile, so no max, no multiply and no writes), their barriers
             still passing;
  no_dy      dy's TMA loads left out (the ring's barriers still pass);
  no_x       the x halo's TMA loads left out;
  no_mma     the wgmma left out;
  no_fadd    the chains' adds into the running totals left out but one a
             tap (with none, ptxas drops the wgmma whose sums nothing reads).

And what a change would give (skipped where the source lacks the text;
read_again, x_rows and chain1 are cuts of the earlier fp16 design, which
scaled every tile by one exponent found in a pass over dy before the
kernel):

  deeper     a fifth ring stage;
  deeper_no_scale  that and no_scale;
  read_again fp16: the scaling warps read each scaled tile once more, after
             the consumers may start on it: shared-memory traffic off the
             critical path;
  x_rows     the x halo as one TMA box of 128-byte swizzled rows (where
             Ci > 8), its wgmma descriptor shifted by rows;
  chain1     chains of one voxel tile (8 k16 steps).

The variants that keep the kernel's arithmetic (deeper, read_again,
x_rows) are checked bitwise against base's result.

Each cut is made by text on the source; a cut has one text for each
design it knows (the first whose every piece is found is taken), and a cut
none of whose texts is found stops the tool, but for the variants above
that a source may lack (no_absmax and the changes). Prints the card's
name and power limit first. A launch the card has not finished within 30 s ends the
tool (a hung variant fails the run instead of holding the card).
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pcmseg_tpu_torch.ops.kernels import build  # noqa: E402

OUT = REPO / "build" / "ablate_conv3x3_dw"
# cut name -> the designs' texts: [[(the text cut, what takes its place), ...], ...]
CUTS = {
    "absmax": [
        # dy's max in a pass of its own (the earlier design)
        [("    err = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);", "    err = cudaSuccess;"),
         ("    f16_absmax<<<blocks, 256, 0, s>>>(static_cast<const uint4*>(dy), count8, amax);", "    (void)blocks;")],
    ],
    "scale": [
        # the scaling warps' reads of each tile (so no max, no multiply and no writes: every exponent is 0)
        [("q[u] = stid + u * SCALERS < DY_WORDS ? tile[stid + u * SCALERS] : make_uint4(0, 0, 0, 0);",
          "q[u] = make_uint4(0, 0, 0, 0);")],
        # the earlier design: the whole tensor's exponent, each tile scaled in shared memory
        [("        for (int i = stid; i < DY_BYTES / 16; i += SCALERS) {",
          "        for (int i = stid; i < 0; i += SCALERS) {")],
    ],
    "dy": [
        [("mbar_expect_tx(dy_full(s), DY_BYTES);", "mbar_arrive(dy_full(s));"),
         ("tma_load_5d(st, &dymap, dy_full(s), co0, x0, y0, z0, n);", ""),
         ("mbar_expect_tx(full(s), DY_BYTES + C::X_BYTES);", "mbar_expect_tx(full(s), C::X_BYTES);"),
         ("tma_load_5d(st, &dymap, full(s), co0, x0, y0, z0, n);", "")],
        [("tma_load_5d(st, &dymap, full(s), co0, x0, y0, z0, n);", ""),
         ("mbar_expect_tx(full(s), DY_BYTES + C::SLABS * C::SLAB);", "mbar_expect_tx(full(s), C::SLABS * C::SLAB);")],
    ],
    "x": [
        [("mbar_expect_tx(full(s), C::X_BYTES);", "mbar_arrive(full(s));"),
         ("tma_load_5d(st + DY_BYTES, &xmap, full(s), ci0, x0 - 1, y0 - 1, z0 - 1 + kd, n);", ""),
         ("mbar_expect_tx(full(s), DY_BYTES + C::X_BYTES);", "mbar_expect_tx(full(s), DY_BYTES);")],
        [("        for (int g = 0; g < C::SLABS; ++g)\n"
          "          tma_load_5d(st + DY_BYTES + g * C::SLAB, &xmap, full(s), ci0 + 8 * g, x0 - 1, y0 - 1,\n"
          "                      z0 - 1 + kd, n);\n", ""),
         ("mbar_expect_tx(full(s), DY_BYTES + C::SLABS * C::SLAB);", "mbar_expect_tx(full(s), DY_BYTES);")],
    ],
    "deeper": [[("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")]],
    "read_again": [
        [("        if (stid == 0) mbar_arrive(scaled(s));\n",
          "        if (stid == 0) mbar_arrive(scaled(s));\n"
          "        unsigned sink = 0;\n"
          "        for (int i = stid; i < DY_BYTES / 16; i += SCALERS) sink ^= tile[i].x ^ tile[i].w;\n"
          "        if (sink == 0x9e3779b9u) a.dst[0] = 0.f;  // keeps the reads\n")],
    ],
    "x_rows": [
        [("  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 8, HX, HY, p.small ? TZ + 2 : TZ, false, type);",
          "  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, p.small ? 8 : BC, HX, HY, p.small ? TZ + 2 : TZ, !p.small, "
          "type);"),
         ("        for (int g = 0; g < C::SLABS; ++g)\n", "        for (int g = 0; g < 1; ++g)\n"),
         ("          const uint64_t da = gmma_desc(xs + row * 16, HX * 16, SMALL ? 16 : C::SLAB, LAYOUT_INTERLEAVE);",
          "          const uint64_t da = SMALL ? gmma_desc(xs + row * 16, HX * 16, 16, LAYOUT_INTERLEAVE)\n"
          "                                    : gmma_desc(xs + row * 128, 16, HX * 128, LAYOUT_B128);")],
    ],
    # the earlier design only: the pair logic of the per-chain scale assumes two tiles a chain
    "chain1": [[("constexpr int CHAIN_TILES = 2;", "constexpr int CHAIN_TILES = 1;"),
                ("        for (int i = stid; i < DY_BYTES / 16; i += SCALERS) {",
                 "        for (int i = stid; i < DY_BYTES / 16; i += SCALERS) {")]],
    "mma": [
        [("wgmma_m64n64k16<1, 1, T>(acc, da, db, q > 0 || j > 0);", "")],
    ],
    # one add of the 32 kept: with none, ptxas drops the wgmma whose sums nothing reads
    "fadd": [
        [("for (int k = 0; k < 32; ++k) total[aa][k] += acc[k];",
          "for (int k = 0; k < 1; ++k) total[aa][k] += acc[k];")],
        [("for (int k = 0; k < 32; ++k) total[aa][k] = fmaf(acc[k], down, total[aa][k]);",
          "for (int k = 0; k < 1; ++k) total[aa][k] = fmaf(acc[k], down, total[aa][k]);")],
    ],
}
VARIANTS = {"base": (), "no_absmax": ("absmax",), "no_scale": ("scale",), "no_dy": ("dy",), "no_x": ("x",),
            "no_mma": ("mma",), "no_fadd": ("fadd",), "deeper": ("deeper",), "deeper_no_scale": ("deeper", "scale"),
            "read_again": ("read_again",), "x_rows": ("x_rows",), "chain1": ("chain1",)}
# skipped where the source lacks their text; checked bitwise against base where the arithmetic is kept
OPTIONAL = ("no_absmax", "deeper", "deeper_no_scale", "read_again", "x_rows", "chain1")
EXACT = ("deeper", "read_again", "x_rows")
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def cut(text: str, name: str):
    """``text`` with the cut ``name`` made, or None where none of its texts
    is in it."""
    for pieces in CUTS[name]:
        if all(old in text for old, _ in pieces):
            for old, new in pieces:
                text = text.replace(old, new)
            return text
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR / "conv3x3_dw.cu")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated, of: " + ", ".join(VARIANTS))
    ap.add_argument("--dtypes", default=",".join(DTYPES), help="comma-separated, of: " + ", ".join(DTYPES))
    args = ap.parse_args()
    dtypes = [DTYPES[d] for d in args.dtypes.split(",")]
    if not torch.cuda.is_available():
        sys.exit("ablate_conv3x3_dw: no CUDA device")
    card = chip_smoke.card_label()
    print(f"card: {card}; source {args.source}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = args.source.read_text()
    src = src.replace('#include "hopper.cuh"', f'#include "{args.source.parent.resolve() / "hopper.cuh"}"')
    procs = {}
    for name in args.variants.split(","):
        text = src
        for c in VARIANTS[name]:
            text = cut(text, c)
            if text is None:
                break
        if text is None:
            if name in OPTIONAL:
                print(f"{name}: not a cut of this source; skipped", flush=True)
                continue
            sys.exit(f"ablate_conv3x3_dw: none of the {name!r} cut's texts is in the source")
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                                        str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"ablate_conv3x3_dw: {name} did not build:\n{log[-3000:]}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name in procs:
        lib = libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.pcmseg_conv3x3_dw_workspace_bytes.restype = ll
        lib.pcmseg_conv3x3_dw_workspace_bytes.argtypes = [i] * 7
        for entry in ("pcmseg_conv3x3_dw_bf16", "pcmseg_conv3x3_dw_f16"):
            getattr(lib, entry).argtypes = [p] * 4 + [ll] + [i] * 6 + [p, i]
        if hasattr(lib, "pcmseg_conv3x3_dw_f16_workspace_bytes"):  # the earlier design: max|dy| after the partials
            lib.pcmseg_conv3x3_dw_f16_workspace_bytes.restype = ll
            lib.pcmseg_conv3x3_dw_f16_workspace_bytes.argtypes = [i] * 7
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    sums = {}
    for dtype in dtypes:
        tag = "bf16" if dtype == torch.bfloat16 else "fp16"
        entry = "pcmseg_conv3x3_dw_bf16" if dtype == torch.bfloat16 else "pcmseg_conv3x3_dw_f16"
        for ci, co, s, layers in chip_smoke.CONV_SHAPES:
            kci = 8 if ci <= 8 else ci  # the input conv's 5 channels padded to 8
            x = torch.randn((1, s, s, s, kci), generator=g, device=dev).to(dtype)
            # the fp16 step's dy lies far below 1: scaled by 2^20
            dy = (torch.randn((1, s, s, s, co), generator=g, device=dev) * (2.0**-20 if tag == "fp16" else 1.0)).to(
                dtype)
            out = torch.empty((27, kci, co), dtype=torch.float32, device=dev)
            bound, flop, _ = chip_smoke.conv_bound(ci, co, s, dw=True)
            label = f"{ci}->{co}@{s}^3"
            for name, lib in libs.items():
                ws_fn = lib.pcmseg_conv3x3_dw_workspace_bytes
                if tag == "fp16" and hasattr(lib, "pcmseg_conv3x3_dw_f16_workspace_bytes"):
                    ws_fn = lib.pcmseg_conv3x3_dw_f16_workspace_bytes
                ws = ws_fn(1, s, s, s, kci, co, 0)
                workspace = torch.zeros(max(ws, 16), dtype=torch.uint8, device=dev)
                fn = getattr(lib, entry)

                def run():
                    rc = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), workspace.data_ptr(), ws, 1, s, s, s, kci,
                            co, torch.cuda.current_stream().cuda_stream, 0)
                    if rc:
                        raise RuntimeError(f"{name} {tag} {label}: launch failed ({rc})")

                note = ""
                if name == "base" or name in EXACT:
                    run()
                    finish(f"{name} {tag} {label}")
                    if name == "base":
                        want = out.clone()
                    elif "base" in libs:
                        note = ", bitwise equal to base" if torch.equal(out, want) else ", DIFFERS from base"
                ms = graph_ms(run)
                sums[(tag, name)] = sums.get((tag, name), 0.0) + layers * ms
                print(f"{tag} {label} x{layers} {name}: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
                      f"({bound / ms:.3f} of the bound {bound:.4f} ms){note} [{card}]", flush=True)
            del x, dy, out
        base = sums.get((tag, "base"))
        for name in libs:
            ms = sums[(tag, name)]
            rel = f", {ms / base:.3f} of base" if base else ""
            print(f"{tag} 18 dW layers of one 128^3 microbatch, {name}: {ms:.3f} ms{rel} [{card}]", flush=True)
    return 0


def finish(label: str, limit: float = 30.0) -> None:
    """Wait for the card's queued work; end the process if it takes longer
    than ``limit`` seconds."""
    done = torch.cuda.Event()
    done.record()
    start = time.time()
    while not done.query():
        if time.time() - start > limit:
            print(f"ablate_conv3x3_dw: HANG in {label}", flush=True)
            os._exit(3)
        time.sleep(0.0005)


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """ms a launch of ``fn``: ``launches`` calls captured in one CUDA graph,
    replayed ``replays`` times between two events after one warm replay."""
    fn()
    finish("a first launch")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    finish("a graph replay")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


if __name__ == "__main__":
    sys.exit(main())
