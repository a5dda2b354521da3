"""Where the 16-bit 3³ conv kernel's (B1's) time goes, on one NVIDIA GPU.

    python tools/ablate_conv3x3x3.py [--source PATH] [--variants a,b,...] [--deep]

Builds copies of ``pcmseg_tpu_torch/csrc/conv3x3x3.cu`` (or of the B1
source at PATH, e.g. a parent checkout's, with its ``hopper.cuh`` beside
it: then only ``base``) with parts of its work taken out (each copy's
results are wrong: they are timed, not checked), one nvcc process a copy,
into ``build/ablate_conv3x3x3/``, and times each in bf16 at 12 of the
model's shapes, beside the share of the bf16 bound (989 TFLOP/s). A time is the
card's alone: 20 launches captured in one CUDA graph, the graph replayed
5 times between two CUDA events, per launch.

  base       the kernel as it is;
  no_weight  the weight tiles' TMA loads left out (the ring's barriers
             still pass): what feeding the weight from L2 costs;
  no_halo    the activation halo's TMA loads left out;
  no_loads   both left out;
  no_mma     the wgmma left out: the TMA pipeline, barriers and epilogue;
  no_store   the epilogue's stores to device memory left out;
  local_sum  split K: each block adds its own partial in place of its
             peers' (no distributed shared memory read);
  no_barrier that without the cluster barriers, still launched as
             clusters;
  no_cluster that, and launched without clusters;
  splits     the kernel as it is, its plan forced to each count of splits
             of K in turn (1: persistent blocks), each distinct plan timed.

--deep takes the shapes at 32^3 and below, of the whole volume, one of 2
D-slabs with its halo and one of 2 output-channel shards, forward and dx,
where the plan's splits are chosen. The cuts are made by text on the
source; a cut whose text is not found stops the tool. Prints the card's
name and power limit first, and the clusters it holds at once.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import torch  # noqa: E402

from pcmseg_tpu_torch.ops.kernels import build, conv3d  # noqa: E402

OUT = REPO / "build" / "ablate_conv3x3x3"
# split K: the cluster barriers, and the peers' partials read locally
SPLIT_SYNC = [
    ("    if constexpr (!PERSIST) {  // the consumers' two cluster barriers\n      cluster_sync();\n"
     "      cluster_sync();\n    }\n", ""),
    ("    cluster_sync();\n    const int rank", "    const int rank"),
    ("    cluster_sync();  // the peers are done reading this block's partial", ""),
    ("        if (k < splits) p[k] = ld_cluster_f4(cluster_map(addr, rank));",
     "        if (k < splits) p[k] = ld_cluster_f4(addr);"),
]
# cut name -> [(the text cut, what takes its place), ...], each applied in turn
CUTS = {
    "weight": [("          mbar_expect_tx(full(s), C::B_BYTES);\n"
                "          tma_load_2d(b_smem + s * C::B_BYTES, &wmap, full(s), wcol(u % STEPS, u / STEPS), n0);",
                "          mbar_arrive(full(s));")],
    "halo": [("          mbar_expect_tx(halo_full(hb), SMALL ? C::SLAB : C::HALO);\n"
              "          tma_load_5d(halo(hb), &xmap, halo_full(hb), c * CHUNK, t.x0 - 1, t.y0 - 1, t.z0 - 1, t.n);",
              "          mbar_arrive(halo_full(hb));")],
    "mma": [("            wgmma_bn<BN, T>(d[m], da, db);", "")],
    "store": [("        tma_store_5d(&omap, stage + b * (C::VOX * 128), t.n0 + 64 * b, t.x0, t.y0, t.z0, t.n);",
               "        continue;"),
              ("        if (z >= a.D || y >= a.H || x >= a.W || col >= a.Co) continue;", "        continue;")],
    # split K: each block sums its own partial S times (no peer's shared memory)
    "dsmem": [("        if (k < splits) p[k] = ld_cluster_f4(cluster_map(addr, k));",
               "        if (k < splits) p[k] = ld_cluster_f4(cluster_map(addr, rank));")],
    "barrier": SPLIT_SYNC,  # with the dsmem cut
    "cluster": SPLIT_SYNC + [("  cfg.numAttrs = p.splits > 1 ? 1 : 0;", "  cfg.numAttrs = 0;")],  # with dsmem
    # the plan's splits set by pcmseg_ablate_force_splits (0: make_plan's own)
    "force": [("// ---- launch plan ----", "int force_splits = 0;\n\n// ---- launch plan ----"),
              ("    const long long cost = plan_cost(items, splits, per, sms, clusters);",
               "    const long long cost = force_splits == 0 ? plan_cost(items, splits, per, sms, clusters)\n"
               "                                              : s == force_splits ? 0 : 1;"),
              ("}  // extern \"C\"", "void pcmseg_ablate_force_splits(int s) { force_splits = s; }\n\n}  // extern \"C\"")],
}
VARIANTS = {"base": (), "no_weight": ("weight",), "no_halo": ("halo",), "no_loads": ("weight", "halo"),
            "no_mma": ("mma",), "no_store": ("store",), "local_sum": ("dsmem",), "no_barrier": ("dsmem", "barrier"),
            "no_cluster": ("dsmem", "cluster"), "splits": ("force",)}
# (Ci, Co, D, H = W); Ci = 8: the input conv (5 modalities padded), whole and one of 2 channel shards
SHAPES = ((8, 64, 128, 128), (8, 32, 128, 128), (64, 64, 128, 128), (64, 128, 128, 128), (128, 64, 128, 128),
          (128, 128, 64, 64), (256, 256, 32, 32), (512, 512, 16, 16), (1024, 512, 16, 16), (512, 1024, 8, 8),
          (1024, 512, 8, 8), (1024, 1024, 8, 8))


def deep_shapes() -> list:
    """The model's forward and dx shapes at 32^3 and below: of the whole
    volume, one of 2 D-slabs with its halo, one of 2 output-channel shards
    (of dy's channels for dx), each once."""
    layers = ((128, 256, 32), (256, 256, 32), (256, 512, 16), (512, 512, 16), (512, 1024, 8), (1024, 1024, 8),
              (1024, 512, 16), (512, 256, 32))
    shapes = []
    for ci, co, s in layers:
        for d, shard in ((s, 1), (s // 2 + 2, 1), (s, 2)):
            for shape in ((ci, co // shard, d, s), (co // shard, ci, d, s)):
                if shape not in shapes:
                    shapes.append(shape)
    return shapes


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR / "conv3x3x3.cu")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated, of: " + ", ".join(VARIANTS))
    ap.add_argument("--deep", action="store_true", help="the shapes at 32^3 and below, slabs and shards too")
    args = ap.parse_args()
    variants = {name: VARIANTS[name] for name in args.variants.split(",")}
    shapes = deep_shapes() if args.deep else SHAPES
    if not torch.cuda.is_available():
        sys.exit("ablate_conv3x3x3: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; source {args.source}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = args.source.read_text()
    src = src.replace('#include "hopper.cuh"', f'#include "{args.source.parent.resolve() / "hopper.cuh"}"')
    procs = {}
    for name, cuts in variants.items():
        text = src
        for cut in cuts:
            for old, new in CUTS[cut]:
                if old not in text:
                    sys.exit(f"ablate_conv3x3x3: the {cut!r} cut's text {old[:60]!r}... is not in the source")
                text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                                        str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"ablate_conv3x3x3: {name} did not build:\n{log[-3000:]}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, clusters = {}, None
    for name in variants:
        lib = libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        if hasattr(lib, "pcmseg_conv3x3x3_workspace_bytes"):  # a design with a split-K workspace
            lib.pcmseg_conv3x3x3_workspace_bytes.restype = ll
            lib.pcmseg_conv3x3x3_workspace_bytes.argtypes = [i] * 7
            lib.pcmseg_conv3x3x3_bf16.argtypes = [p] * 5 + [ll] + [i] * 7 + [p, i]
        else:
            lib.pcmseg_conv3x3x3_bf16.argtypes = [p] * 4 + [i] * 7 + [p, i]
            lib.pcmseg_conv3x3x3_plan.argtypes = [i] * 7 + [ctypes.POINTER(i), ctypes.POINTER(ll)]
            if clusters is None:
                table = (i * conv3d.B1_MAX_CLUSTER)()
                lib.pcmseg_conv3x3x3_clusters.argtypes = [i, ctypes.POINTER(i)]
                lib.pcmseg_conv3x3x3_clusters(0, table)
                clusters = table
                print(f"clusters of 1..{conv3d.B1_MAX_CLUSTER} split blocks held at once: {list(table)} "
                      f"({sms} SMs) [{card}]", flush=True)
    for ci, co, d, s in shapes:
        x = torch.randn((1, d, s, s, ci), device=dev).to(torch.bfloat16)
        w = conv3d.pack_weight(torch.randn((co, ci, 3, 3, 3), device=dev) * 0.05, torch.bfloat16)
        b = torch.zeros(co, device=dev)
        out = torch.empty((1, d, s, s, co), dtype=torch.bfloat16, device=dev)
        flop = 2 * 27 * ci * co * d * s * s
        label = f"{ci}->{co}@{d}x{s}^2"
        for name, lib in libs.items():
            if hasattr(lib, "pcmseg_conv3x3x3_workspace_bytes"):
                ws = lib.pcmseg_conv3x3x3_workspace_bytes(1, d, s, s, ci, co, 0)
                workspace = torch.empty(max(ws, 16), dtype=torch.uint8, device=dev)
                lead = (workspace.data_ptr(), ws)
            else:
                lead = ()

            def run():
                rc = lib.pcmseg_conv3x3x3_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *lead,
                                               1, d, s, s, ci, co, 1, torch.cuda.current_stream().cuda_stream, 0)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            forced = (0,) if name != "splits" else range(1, conv3d.B1_MAX_CLUSTER + 1)
            seen = set()
            for k in forced:
                note = ""
                if name == "splits":
                    lib.pcmseg_ablate_force_splits(k)
                    plan = (ll * len(conv3d.PLAN_FIELDS))()
                    lib.pcmseg_conv3x3x3_plan(1, d, s, s, ci, co, sms, clusters, plan)
                    plan = dict(zip(conv3d.PLAN_FIELDS, plan))
                    key = (plan["splits"], plan["k_tiles_per_split"])
                    if key in seen:
                        continue
                    seen.add(key)
                    note = (f" ({plan['splits']} splits of {plan['k_tiles_per_split']} weight tiles, "
                            f"{plan['items']} tiles)")
                ms = graph_ms(run)
                print(f"{label} {name}{note}: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
                      f"({flop / 989e12 * 1e3 / ms:.3f} of the bf16 bound) [{card}]", flush=True)
            if name == "splits":
                lib.pcmseg_ablate_force_splits(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
