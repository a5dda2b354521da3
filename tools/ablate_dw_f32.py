"""Where the fp32 weight-gradient kernel's time goes, on one NVIDIA GPU.

    python tools/ablate_dw_f32.py

Builds copies of ``pcmseg_tpu_torch/csrc/conv3x3_dw_f32.cu`` with parts of
the consumers' work taken out (each copy's results are wrong: they are
timed, not checked), one nvcc process a copy, into
``build/ablate_dw_f32/``, and times each at two of the model's shapes with
CUDA events (mean of 10 launches after one warm launch), beside the share
of the 3xTF32 bound (494.7 / 3 TFLOP/s):

  base          the kernel as it is;
  no_transpose  dy's transpose and split (the transposer warps) left out;
  no_load       the x fragments' shared loads left out (constants split);
  no_mma        the wgmma left out;
  mma_only      both the transpose and the fragment loads left out;
  pipeline      all three left out: the TMA ring and barriers alone.

The cuts are made by text on the source; a cut whose text is not found
stops the tool. Prints the card's name and power limit first.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch  # noqa: E402

from pcmseg_tpu_torch.ops.kernels import build  # noqa: E402

OUT = REPO / "build" / "ablate_dw_f32"
# (name, the text cut, what takes its place)
CUTS = {
    "transpose": ("for (int item = ttid; item < VOX / 4 * BC; item += TRANSPOSERS) {",
                  "for (int item = ttid; item < 0; item += TRANSPOSERS) {"),
    "load": ("    const float v[4] = {v0.x, v0.y, v4.x, v4.y};",
             "    const float v[4] = {1.f + j, 2.f + u, 3.f, 4.f + c};"),
    "mma": ("  auto mma = [&](float (&d)[32], const uint32_t (&f)[2][4], uint32_t tb, int q, int first) {",
            "  auto mma = [&](float (&d)[32], const uint32_t (&f)[2][4], uint32_t tb, int q, int first) {\n    return;"),
}
VARIANTS = {"base": (), "no_transpose": ("transpose",), "no_load": ("load",), "no_mma": ("mma",),
            "mma_only": ("transpose", "load"), "pipeline": ("transpose", "load", "mma")}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("ablate_dw_f32: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "conv3x3_dw_f32.cu").read_text()
    src = src.replace('#include "hopper.cuh"', f'#include "{build.CSRC_DIR / "hopper.cuh"}"')
    procs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for cut in cuts:
            old, new = CUTS[cut]
            if old not in text:
                sys.exit(f"ablate_dw_f32: the {cut!r} cut's text is not in the source")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                                        str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"ablate_dw_f32: {name} did not build:\n{log[-3000:]}")
    dev = torch.device("cuda")
    for ci, co, s in ((64, 64, 128), (256, 256, 32)):
        x = torch.randn((1, s, s, s, ci), device=dev)
        dy = torch.randn((1, s, s, s, co), device=dev)
        out = torch.empty((27, ci, co), device=dev)
        flop = 2 * 27 * ci * co * s ** 3
        for name in VARIANTS:
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            lib.pcmseg_conv3x3_dw_f32_workspace_bytes.restype = ctypes.c_longlong
            lib.pcmseg_conv3x3_dw_f32_workspace_bytes.argtypes = [ctypes.c_int] * 7
            lib.pcmseg_conv3x3_dw_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                                                  + [ctypes.c_void_p, ctypes.c_int])
            ws = lib.pcmseg_conv3x3_dw_f32_workspace_bytes(1, s, s, s, ci, co, 0)
            workspace = torch.empty(max(ws, 16), dtype=torch.uint8, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                rc = lib.pcmseg_conv3x3_dw_f32(x.data_ptr(), dy.data_ptr(), out.data_ptr(), workspace.data_ptr(), ws,
                                               1, s, s, s, ci, co, stream, 0)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 10
            print(f"{ci}->{co}@{s} {name}: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
                  f"({flop / (494.7e12 / 3) * 1e3 / ms:.3f} of the 3xTF32 bound) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
