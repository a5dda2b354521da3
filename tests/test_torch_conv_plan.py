"""The 16-bit 3³ conv kernel's launch plan and summation order, on the CPU.

``csrc/conv3x3x3.cu`` (B1: the forward and, on the flipped weight, dx)
runs persistent blocks over output tiles, or splits K (its 64-column
weight tiles, 27 to a 64-channel chunk) over the blocks of a thread block
cluster where the tiles alone would leave the card idle for longer than
the split costs, counting only the clusters the card holds at once; the
cluster sums its fp32 partials on chip, in rank order. A block whose slice
of K is longer than one tensor-core chain (108 weight tiles, 432 k16
steps) adds its chains into fp32 running totals, a chain every 4 of the
chunks its slice spans, whole or in part.
``conv3d.conv_plan`` mirrors the C plan (``chip_smoke.py`` holds the two
equal on the card).

Here: the plan at every flagship forward and dx shape, as a table; every
output voxel and channel written by exactly one block, over the persistent
walk and over a cluster's slices; the longest chain and the shared memory
a block at the model's, the D-slabs', the channel shards', N = 4 and the
96³ crops' shapes; and a numpy emulation of the summation order (each
k16 step's four k4 sums truncated into the tensor-core accumulator,
chains of at most 432 steps added in fp32, the cluster's partials in rank
order) on same-sign fp16 inputs, against the bias of B1's longest sums
that the card showed for the order before this design.
"""

import numpy as np
import pytest

from pcmseg_tpu_torch.ops.kernels import conv3d

SMS = 132  # an H100 SXM (conv_plan's default clusters: conv3d.H100_CLUSTERS)
CHAIN_LIMIT = 432  # k16 steps: the longest chain of the design before (4 chunks)
SMEM_LIMIT = 232_448  # the shared memory a block may use on an H100
# B1's same-sign forward error from float64, mean signed, in fp16 ulps of
# the output, with chains of 432 k16 steps (512->256 @32^3 and 1024->512
# @16^3; chip_smoke.py's dw_sum phase, NVIDIA H100 80GB HBM3 at 700 W)
CARD_BIAS_ULP = 0.066

# (Ci, Co, size) -> (BN, tile depth, splits, weight tiles a split, longest
# chain, gridDim.x, items), N = 1 at 132 SMs: the 14 forward shapes of the
# flagship model
FORWARD = {
    (5, 64, 128): (64, 4, 1, 4, 16, 132, 8192),
    (64, 64, 128): (64, 4, 1, 27, 108, 132, 8192),
    (64, 128, 64): (128, 2, 1, 27, 108, 132, 2048),
    (128, 128, 64): (128, 2, 1, 54, 216, 132, 2048),
    (128, 256, 32): (128, 2, 1, 54, 216, 132, 512),
    (256, 256, 32): (128, 2, 1, 108, 432, 132, 512),
    (256, 512, 16): (128, 2, 1, 108, 432, 128, 128),
    (512, 512, 16): (128, 2, 1, 216, 432, 128, 128),
    (512, 1024, 8): (128, 2, 3, 72, 288, 32, 32),
    (1024, 1024, 8): (128, 2, 3, 144, 432, 32, 32),
    (1024, 512, 16): (128, 2, 1, 432, 432, 128, 128),
    (512, 256, 32): (128, 2, 1, 216, 432, 132, 512),
    (256, 128, 64): (128, 2, 1, 108, 432, 132, 2048),
    (128, 64, 128): (64, 4, 1, 54, 216, 132, 8192),
}
# and the 13 dx shapes (B1 on dy: Ci is the layer's Co; the input conv has no dx)
DX = {
    (64, 64, 128): (64, 4, 1, 27, 108, 132, 8192),
    (128, 64, 64): (64, 4, 1, 54, 216, 132, 1024),
    (128, 128, 64): (128, 2, 1, 54, 216, 132, 2048),
    (256, 128, 32): (128, 2, 1, 108, 432, 132, 256),
    (256, 256, 32): (128, 2, 1, 108, 432, 132, 512),
    (512, 256, 16): (128, 2, 2, 108, 432, 64, 64),
    (512, 512, 16): (128, 2, 1, 216, 432, 128, 128),
    (1024, 512, 8): (128, 2, 6, 72, 288, 16, 16),
    (1024, 1024, 8): (128, 2, 3, 144, 432, 32, 32),
    (512, 1024, 16): (128, 2, 1, 216, 432, 132, 256),
    (256, 512, 32): (128, 2, 1, 108, 432, 132, 1024),
    (128, 256, 64): (128, 2, 1, 54, 216, 132, 4096),
    (64, 128, 128): (128, 2, 1, 27, 108, 132, 16384),
}
TABLE = [("forward", *k, *v) for k, v in FORWARD.items()] + [("dx", *k, *v) for k, v in DX.items()]


@pytest.mark.parametrize("kind,ci,co,size,bn,tz,splits,per,chain,grid_x,items", TABLE,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}@{r[3]}" for r in TABLE])
def test_plan_at_flagship_shapes(kind, ci, co, size, bn, tz, splits, per, chain, grid_x, items):
    plan = conv3d.conv_plan(1, size, size, size, ci, co, SMS)
    got = tuple(plan[k] for k in ("bn", "tile_z", "splits", "k_tiles_per_split", "chain_steps", "grid_x", "items"))
    assert got == (bn, tz, splits, per, chain, grid_x, items)
    assert plan["instruction"] == f"m64n{bn}k16" and (plan["tile_y"], plan["tile_x"]) == (8, 8)
    # no flagship shape sends split partials through device memory; a slice
    # longer than 108 weight tiles (432 k16 steps) cuts its chains in the block
    assert plan["workspace_bytes"] == 0 and plan["cut"] == (per > conv3d.B1_CHAIN_K_TILES)
    assert plan["splits"] <= conv3d.B1_MAX_CLUSTER
    # persistent blocks: a 4-stage ring, two halo buffers, the rounded tile;
    # split K: the ring as deep as the rest of shared memory allows
    assert (plan["stages"], plan["smem_bytes"]) == {
        (64, False): (4, 220_256), (128, False): (4, 201_824), (64, True): (9, 228_528),
        (128, True): (7, 218_256)}[bn, splits > 1]


def _written(plan: dict, n: int, d: int, h: int, w: int, co: int) -> np.ndarray:
    """How often each output element (n, d, h, w, co) is stored under
    ``plan``: every block's items (blockIdx.x, + gridDim.x, ...), each item
    a tile of tile_z x 8 x 8 voxels and BN channels clipped to the volume
    (the TMA store's clip, or the split epilogue's bounds), and with split
    K, each cluster rank's slice of the tile's column groups."""
    tz, bn, splits = plan["tile_z"], plan["bn"], plan["splits"]
    mz = tz // 2
    groups = mz * bn // 8  # (z-plane of a warpgroup, 8-channel group) pairs
    co_blocks = -(-co // bn)
    tiles = (-(-d // tz), -(-h // 8), -(-w // 8))
    count = np.zeros((n, d, h, w, co), np.int32)
    blocks = plan["grid_x"]
    for block in range(blocks):
        for item in range(block, plan["items"], blocks):
            n0 = (item % co_blocks) * bn
            r = item // co_blocks
            x0 = (r % tiles[2]) * 8
            r //= tiles[2]
            y0 = (r % tiles[1]) * 8
            r //= tiles[1]
            z0 = (r % tiles[0]) * tz
            b = r // tiles[0]
            for rank in range(splits):
                g0, g1 = rank * groups // splits, (rank + 1) * groups // splits
                if splits == 1:
                    g0, g1 = 0, groups
                for g in range(g0, g1):
                    m, j = divmod(g, bn // 8)
                    for wg in range(2):  # both warpgroups' plane m
                        z = z0 + wg * mz + m
                        if z < d:
                            count[b, z, y0:y0 + 8, x0:x0 + 8, n0 + 8 * j:min(co, n0 + 8 * j + 8)] += 1
    return count


@pytest.mark.parametrize("n,d,h,w,ci,co", [
    (1, 32, 32, 32, 512, 256), (1, 16, 16, 16, 1024, 512), (1, 8, 8, 8, 1024, 1024), (1, 8, 8, 8, 1024, 512),
    (1, 16, 16, 16, 256, 512), (2, 9, 7, 13, 8, 24), (1, 5, 6, 7, 64, 8), (3, 6, 6, 6, 128, 72),
    (1, 18, 16, 16, 512, 512), (4, 6, 6, 6, 1024, 512), (1, 4, 4, 4, 2176, 64), (1, 16, 16, 16, 192, 128),
    (1, 34, 32, 32, 64, 32),
], ids=lambda v: str(v))
def test_every_output_written_once(n, d, h, w, ci, co):
    plan = conv3d.conv_plan(n, d, h, w, ci, co, SMS)
    count = _written(plan, n, d, h, w, co)
    assert count.min() == 1 and count.max() == 1, (plan, count.min(), count.max())


def _level_shapes(size: int, n: int = 1, depth: int = 0, co_div: int = 1, ci_div: int = 1):
    """(n, d, h, w, ci, co) of every forward and dx conv of the flagship
    model at a cubic ``size`` (D = ``depth`` at the first level where given,
    halved a level like the rest), Co / ``co_div`` (a forward's channel
    shard) or Ci / ``ci_div`` (dx on a shard of dy)."""
    out = []
    for shapes in (FORWARD, DX):
        for ci, co, s in shapes:
            level = {128: 0, 64: 1, 32: 2, 16: 3, 8: 4}[s]
            hw = size >> level
            d = ((depth - 2) >> level) + 2 if depth else hw
            out.append((n, d, hw, hw, max(ci // ci_div, 1) if ci > 8 else ci, co // co_div))
    return out


CONTRACT = {
    "model": _level_shapes(128),
    "D-slab": _level_shapes(128, depth=66),  # one of 2 D-slabs with its halo slices
    "shard": _level_shapes(128, co_div=2) + _level_shapes(128, ci_div=2),  # one of 2 channel shards
    "N=4": _level_shapes(128, n=4),  # the serving tile batch (a 160x160x144 case in 128^3 windows)
    "96^3 crops": _level_shapes(96),
}


@pytest.mark.parametrize("which", list(CONTRACT))
def test_chains_and_shared_memory_within_limits(which):
    for n, d, h, w, ci, co in CONTRACT[which]:
        plan = conv3d.conv_plan(n, d, h, w, ci, co, SMS)
        assert plan["chain_steps"] <= CHAIN_LIMIT, (which, n, d, h, w, ci, co, plan)
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["workspace_bytes"] == 0
        assert 1 <= plan["splits"] <= conv3d.B1_MAX_CLUSTER
        units = 4 if conv3d.ci_pad(ci) == 8 else conv3d.ci_pad(ci) // 64 * 27
        assert (plan["splits"] - 1) * plan["k_tiles_per_split"] < units


@pytest.mark.parametrize("n,d,ci,co,splits,per", [
    (1, 16, 1024, 512, 1, 432),  # persistent, four chains a tile
    (1, 4, 2176, 64, 8, 115),  # a cluster of 8, slices that start and end inside a chunk
    (4, 6, 1024, 512, 2, 216),  # N = 4 at the bottleneck: a cluster of 2
    (1, 8, 1024, 1024, 3, 144),  # the bottleneck: a cluster of 3
])
def test_long_slices_cut_their_chains(n, d, ci, co, splits, per):
    """A block whose slice of K is longer than 108 weight tiles adds a chain
    every 4 chunks its slice spans (at most 432 k16 steps) into fp32
    running totals (CUT); block 0's first chain is 4 whole chunks."""
    plan = conv3d.conv_plan(n, d, d, d, ci, co, SMS)
    assert (plan["splits"], plan["k_tiles_per_split"]) == (splits, per)
    assert plan["cut"] and plan["chain_steps"] == CHAIN_LIMIT
    for rank in range(splits):
        u0, u1 = rank * per, min(conv3d.ci_pad(ci) // 64 * 27, (rank + 1) * per)
        longest = max(len([u for u in range(u0, u1) if (u // 27 - u0 // 27) // 4 == k]) for k in range(per))
        assert longest <= conv3d.B1_CHAIN_K_TILES


def _round_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounding toward zero."""
    f = v.astype(np.float32)
    past = np.abs(f.astype(np.float64)) > np.abs(v)
    f[past] = np.nextafter(f[past], np.float32(0))
    return f


def _emulate(k4: np.ndarray, splits: int, per: int, chain_chunks: int = 4) -> np.ndarray:
    """The kernel's fp32 sums of ``k4`` (elements, chunks, 27 taps, 4 k16
    steps, 4 k4 sums; float64): K's weight tiles (a chunk's tap) in slices
    of ``per``, each slice's tiles in order, every k4 sum added into the
    tensor-core accumulator rounding toward zero, a fresh accumulator at
    every ``chain_chunks``-th chunk the slice spans, added into the block's
    fp32 running total (round to nearest), the slices' partials added in
    rank order."""
    elements, chunks = k4.shape[:2]
    tiles = k4.reshape(elements, chunks * 27, 16)
    partials = []
    for rank in range(splits):
        u0, u1 = rank * per, min(chunks * 27, (rank + 1) * per)
        total = np.zeros(elements, np.float32)
        acc = np.zeros(elements, np.float32)
        for u in range(u0, u1):
            if u > u0 and u % 27 == 0 and (u // 27 - u0 // 27) % chain_chunks == 0:
                total = total + acc
                acc = np.zeros_like(acc)
            for q in range(16):
                acc = _round_toward_zero(acc.astype(np.float64) + tiles[:, u, q])
        partials.append(total + acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


def _bias_ulp(ci: int, splits: int, per: int, chain_chunks: int, seed: int, elements: int = 4096) -> float:
    """Mean signed error from float64, in fp16 ulps of the output, of fp16
    outputs summed as ``_emulate`` sums them from same-sign fp16 x and
    weights (x = |normal|, w = |normal|·sqrt(2 / (27 Ci))), rounded to fp16
    to nearest."""
    rng = np.random.default_rng(seed)
    chunks = ci // 64
    k4 = np.empty((elements, chunks, 27, 4, 4))
    exact = np.zeros(elements)
    for c in range(chunks):
        x = np.abs(rng.standard_normal((elements, 27, 64))).astype(np.float16).astype(np.float64)
        w = (np.abs(rng.standard_normal((elements, 27, 64))) * np.sqrt(2.0 / (27 * ci))).astype(np.float16)
        p = x * w.astype(np.float64)  # exact: two 11-bit significands
        k4[:, c] = p.reshape(elements, 27, 4, 4, 4).sum(-1)
        exact += p.sum((1, 2))
    got = _emulate(k4, splits, per, chain_chunks).astype(np.float16).astype(np.float64)
    ulp = np.ldexp(1.0, np.frexp(exact)[1] - 11)
    return float(((got - exact) / ulp).mean())


@pytest.mark.parametrize("ci,co,size", [(1024, 1024, 8), (1024, 512, 16)])
def test_summation_order_bias_within_the_card_reading(ci, co, size):
    """The new order at the bottleneck's longest sums (K = 27·1024): the
    emulated mean bias of the fp16 output within what the card showed for
    432-step chains in the order before; a chain of the whole K (1,728
    steps, what one unsplit block would run without cutting) loses more."""
    plan = conv3d.conv_plan(1, size, size, size, ci, co, SMS)
    assert plan["chain_steps"] <= CHAIN_LIMIT
    seed = ci + co + size
    bias = _bias_ulp(ci, plan["splits"], plan["k_tiles_per_split"], 4, seed)
    assert abs(bias) <= CARD_BIAS_ULP, bias
    whole = _bias_ulp(ci, 1, ci // 64 * 27, ci // 64, seed, elements=1024)
    assert whole < bias and abs(whole) > CARD_BIAS_ULP, (whole, bias)
