"""The fp16 weight gradient's per-chain dy scale, on the CPU.

``csrc/conv3x3_dw.cu`` sums each tensor-core chain (two voxel tiles of 2x8x8
voxels, 16 k16 steps) of fp16 dy·2^k_c in place of dy, k_c =
``conv3d_grad.f16_scale_exponent`` of the chain's max|dy|, and multiplies
the chain's fp32 sum by 2^-k_c as it adds it into dW. The scale is found on
the card, per 64-channel block of dy (a block's output channels), with no
pass over dy before the kernel; ``_f16_chains`` below mirrors which tiles
form a chain and each chain's k_c. Here:

  * the chains: every tile of a split once, in order, in chains of one or
    two tiles (a pair aligned to the split's first tile, a last odd tile
    alone), none across a split, a pair cut in two only where its second
    tile's max|dy| lies in a higher binade than its first's (a first tile
    of zeros never cuts), no chain longer than ``dw_plan``'s chain_steps;
  * k_c from each chain's own dy: f16_scale_exponent of its max|dy|;
  * on drawn dy (shares of ±0, subnormals and ±65504, and 64-channel blocks
    many binades apart): each chain's scaled max in [2^14, 2^15) or k_c = 0,
    nothing past 65504, (dy·2^k_c)·2^-k_c equal to dy bit for bit, and a
    float64 dW summed chain by chain from the scaled dy, each chain scaled
    back, equal bit for bit to the same sum of dy;
  * the port's fp16 dW (the plain version on CPU tensors) against the JAX
    kernel (``conv3x3_dw(..., interpret=True)``) on channel-blocked dy, both
    within 1e-6·Σ|x·dy| of float64.

``chip_smoke.py``'s ``dw_sum`` phase holds the kernel itself to float64 on
channel-blocked dy on the card (``dw_blocked``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.ops.pallas.conv3d_grad import conv3x3_dw as jax_dw
from pcmseg_tpu_torch.ops.kernels import conv3d_grad

F16_MAX = 65504.0
F16_TINY = 2.0**-24
SMS = 132  # an H100 SXM
# each fp32 sum of exact fp16 products against float64, over Σ|x·dy|
SUM_BOUND = 1e-6
# (n, d, h, w, ci, co): 2-10 tiles a split, odd and even, 1-3 channel blocks, ragged edges
SHAPES = (
    (1, 10, 16, 8, 64, 128),  # 10 tiles, 2 splits of 5: pairs and a single
    (1, 6, 16, 16, 128, 192),  # 12 tiles, 1 split: pairs; 3 channel blocks
    (2, 5, 9, 12, 8, 136),  # ragged in every dimension, Co past two blocks
    (1, 4, 8, 8, 1024, 64),  # 2 tiles: one pair
)
IDS = [f"{n}x{d}x{h}x{w}-{ci}-{co}" for n, d, h, w, ci, co in SHAPES]


def _dw_tiles(dy: torch.Tensor) -> torch.Tensor:
    """dy (n, d, h, w, co) cut into the kernel's voxel tiles and 64-channel
    blocks: (co blocks, tiles, tile voxels · 64 channels), tiles in the
    kernel's order (x fastest, then y, z, n), the ragged edges and channels
    zero-filled as TMA fills them."""
    n, d, h, w, co = dy.shape
    (tz, ty, tx), bc = conv3d_grad.DW_TILE, conv3d_grad.DW_BLOCK
    pad = dy.new_zeros((n, -(-d // tz) * tz, -(-h // ty) * ty, -(-w // tx) * tx, -(-co // bc) * bc))
    pad[:n, :d, :h, :w, :co] = dy
    t = pad.reshape(n, pad.shape[1] // tz, tz, pad.shape[2] // ty, ty, pad.shape[3] // tx, tx, -1, bc)
    t = t.permute(7, 0, 1, 3, 5, 2, 4, 6, 8)  # (co block, n, tile z, tile y, tile x, in-tile voxels, channels)
    return t.reshape(t.shape[0], -1, tz * ty * tx * bc)


def _f16_chains(dy: torch.Tensor, tiles_per_split: int) -> list:
    """The fp16 kernel's chains and dy scales, as its scaling warps set them:
    for each 64-channel block of dy (the co of a block's dW) a list of
    (first tile, last tile + 1, k), k = ``f16_scale_exponent`` of the
    chain's max|dy|. A split's tiles pair up into chains of two from its
    first (a last odd one alone); the first tile of a pair takes its own k,
    the second the pair's, and the pair is cut into two chains of one tile
    where the pair's k is below the first's (the second tile holds the
    larger |dy|), unless the first tile is all zero."""
    exponent = conv3d_grad.f16_scale_exponent
    out = []
    for block in _dw_tiles(dy).abs().amax(-1).tolist():
        chains = []
        for begin in range(0, len(block), tiles_per_split):
            end = min(len(block), begin + tiles_per_split)
            for t in range(begin, end, conv3d_grad.DW_CHAIN_TILES):
                if t + 1 == end:
                    chains.append((t, t + 1, exponent(block[t])))
                    continue
                k = exponent(max(block[t], block[t + 1]))
                if block[t] == 0 or k == exponent(block[t]):
                    chains.append((t, t + 2, k))
                else:
                    chains += [(t, t + 1, exponent(block[t])), (t + 1, t + 2, k)]
        out.append(chains)
    return out


def _tile_index(n: int, d: int, h: int, w: int) -> torch.Tensor:
    """(n, d, h, w) the kernel's tile of each voxel."""
    tz, ty, tx = conv3d_grad.DW_TILE
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-w // tx)
    i = torch.arange(n).view(n, 1, 1, 1) * nz + torch.arange(d).view(1, d, 1, 1) // tz
    i = (i * ny + torch.arange(h).view(1, 1, h, 1) // ty) * nx + torch.arange(w).view(1, 1, 1, w) // tx
    return i


def _draw(rng, shape, kind: str) -> torch.Tensor:
    """fp16 dy: ``blocked`` puts channels 0-63 near the top of fp16's range
    and every other channel at m·2^-24 (m in [1, 8)); ``spread`` gives each
    64-channel block and each tile its own binade, 0-40 below 2^14, with
    shares of ±0, subnormals and ±65504; mixed signs."""
    n, d, h, w, co = shape
    if kind == "blocked":
        v = rng.integers(1, 8, shape) * F16_TINY
        v[..., :64] = np.abs(rng.standard_normal((n, d, h, w, min(co, 64)))) * 2.0**11
    else:
        tiles = _tile_index(n, d, h, w).numpy()
        binade = rng.integers(0, 41, (tiles.max() + 1, -(-co // 64)))
        e = binade[tiles[..., None], np.arange(co) // 64]
        v = np.abs(rng.standard_normal(shape)) * 2.0 ** (13 - e)
        pick = rng.random(shape)
        v = np.where(pick < 0.3, 0.0, v)
        v = np.where((pick >= 0.3) & (pick < 0.4), rng.integers(1, 1024, shape) * F16_TINY, v)
        v = np.where(pick > 0.999, F16_MAX, v)
    v = v * rng.choice([-1.0, 1.0], shape)
    return torch.from_numpy(v).to(torch.float16)


def _chains(shape, dy):
    plan = conv3d_grad.dw_plan(*shape, SMS)
    return plan, _f16_chains(dy, plan["tiles_per_split"])


@pytest.mark.parametrize("kind", ["blocked", "spread"])
@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES, ids=IDS)
def test_chains_cover_each_split_in_pairs(n, d, h, w, ci, co, kind):
    dy = _draw(np.random.default_rng(ci + co), (n, d, h, w, co), kind)
    plan, chains = _chains((n, d, h, w, ci, co), dy)
    amax = _dw_tiles(dy).abs().amax(-1)
    assert len(chains) == -(-co // conv3d_grad.DW_BLOCK)
    per = plan["tiles_per_split"]
    for block, block_chains in zip(amax.tolist(), chains):
        assert [t for c in block_chains for t in range(c[0], c[1])] == list(range(plan["tiles"]))
        for first, end, _ in block_chains:
            assert 1 <= end - first <= conv3d_grad.DW_CHAIN_TILES
            assert (end - first) * conv3d_grad.DW_STEPS_PER_TILE <= plan["chain_steps"]
            assert first // per == (end - 1) // per  # within one split
            if end - first == 2:
                assert (first % per) % 2 == 0
        starts = {c[0] for c in block_chains}
        for t in range(plan["tiles"]):
            pair_first = t % per % 2 == 0 and t + 1 < plan["tiles"] and (t + 1) // per == t // per
            if not pair_first:
                continue
            ka = conv3d_grad.f16_scale_exponent(block[t])
            kpair = conv3d_grad.f16_scale_exponent(max(block[t], block[t + 1]))
            cut = (t + 1) in starts
            assert cut == (block[t] != 0 and kpair < ka)


@pytest.mark.parametrize("kind", ["blocked", "spread"])
@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES, ids=IDS)
def test_chain_exponent_from_its_own_dy(n, d, h, w, ci, co, kind):
    dy = _draw(np.random.default_rng(3 * ci + co), (n, d, h, w, co), kind)
    _, chains = _chains((n, d, h, w, ci, co), dy)
    tiles = _dw_tiles(dy).double()
    for b, block_chains in enumerate(chains):
        for first, end, k in block_chains:
            amax = float(tiles[b, first:end].abs().max())
            assert k == conv3d_grad.f16_scale_exponent(amax)
            top = amax * 2.0**k
            assert k == 0 or 2.0**14 <= top < 2.0**15
            assert top <= F16_MAX


def _scaled_by_chain(dy: torch.Tensor, chains) -> tuple:
    """(dy with each chain's voxels and channels times 2^k_c, in fp16; the
    per-voxel-and-channel exponent as float64)."""
    n, d, h, w, co = dy.shape
    tile = _tile_index(n, d, h, w)
    k = torch.zeros(dy.shape, dtype=torch.float64)
    for b, block_chains in enumerate(chains):
        for first, end, kc in block_chains:
            mask = (tile >= first) & (tile < end)
            k[..., 64 * b:64 * (b + 1)][mask] = kc
    return (dy.double() * torch.exp2(k)).to(torch.float16), k


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["blocked", "spread"])
def test_chain_scale_is_exact(kind, seed):
    n, d, h, w, ci, co = SHAPES[seed % len(SHAPES)]
    rng = np.random.default_rng(100 + seed)
    dy = _draw(rng, (n, d, h, w, co), kind)
    _, chains = _chains((n, d, h, w, ci, co), dy)
    scaled, k = _scaled_by_chain(dy, chains)
    assert bool(torch.isfinite(scaled).all())
    assert float(scaled.abs().max()) <= F16_MAX
    back = (scaled.double() * torch.exp2(-k)).to(torch.float16)
    assert torch.equal(back.view(torch.int16), dy.view(torch.int16))  # signed zeros too


@pytest.mark.parametrize("kind", ["blocked", "spread"])
@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES[:3], ids=IDS[:3])
def test_chain_by_chain_dw_scaled_back_is_the_dw_of_dy(n, d, h, w, ci, co, kind):
    """The float64 dW as the kernel sums it, chain by chain (each chain's
    voxels and 64 channels alone), from dy·2^k_c with each chain's sum times
    2^-k_c, equals bit for bit the same chain-by-chain sum of dy."""
    rng = np.random.default_rng(7 * ci + co)
    dy = _draw(rng, (n, d, h, w, co), kind)
    _, chains = _chains((n, d, h, w, ci, co), dy)
    ci = min(ci, 16)  # the scale is on dy: a few input channels hold every case
    x = torch.from_numpy(np.abs(rng.standard_normal((n, d, h, w, ci)))).to(torch.float16)
    scaled, _ = _scaled_by_chain(dy, chains)
    tile = _tile_index(n, d, h, w)
    want = torch.zeros((3, 3, 3, ci, co), dtype=torch.float64)
    got = torch.zeros_like(want)
    for b, block_chains in enumerate(chains):
        cols = slice(64 * b, min(co, 64 * (b + 1)))
        for first, end, kc in block_chains:
            mask = ((tile >= first) & (tile < end)).unsqueeze(-1).double()
            part = conv3d_grad.conv3x3_dw_reference(x.double(), dy[..., cols].double() * mask)
            want[..., cols] += part
            part = conv3d_grad.conv3x3_dw_reference(x.double(), scaled[..., cols].double() * mask)
            got[..., cols] += part * 2.0**-kc
    assert torch.equal(got, want)


@pytest.mark.parametrize("signs", ["same-sign", "mixed-sign"])
def test_port_fp16_dw_matches_the_jax_kernel_on_channel_blocked_dy(signs):
    """8³, Ci = 16, Co = 128: dy's first 64 channels near 2^13, the other 64
    subnormal (2^-24..2^-21)."""
    rng = np.random.default_rng(11 if signs == "same-sign" else 12)
    x = np.abs(rng.standard_normal((1, 8, 8, 8, 16))).astype(np.float16)
    dy = _draw(rng, (1, 8, 8, 8, 128), "blocked").numpy()
    if signs == "same-sign":
        dy = np.abs(dy)
    assert (np.abs(dy[..., 64:]) < 2.0**-14).all() and np.abs(dy[..., :64]).max() > 2.0**12
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy), interpret=True), np.float64)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = conv3d_grad.conv3x3_dw(xt, dyt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    exact = conv3d_grad.conv3x3_dw_reference(xt.double(), dyt.double()).numpy()
    scale = conv3d_grad.conv3x3_dw_reference(xt.double(), dyt.double().abs()).numpy()
    scale = np.maximum(scale, 1e-300)
    assert (np.abs(got.double().numpy() - exact) / scale).max() <= SUM_BOUND
    assert (np.abs(want - exact) / scale).max() <= SUM_BOUND


def test_f16_chains_at_a_flagship_shape():
    """128→256 @32³ (5 splits of 52 tiles) on the fp16 step's kind of dy, 90%
    zero and the rest subnormal (m·2^-24, m in [1, 8)): every chain a pair of
    16 k16 steps, scaled by 2^36 (7·2^-24 to 7·2^12, in [2^14, 2^15))."""
    rng = np.random.default_rng(5)
    dy = rng.integers(1, 8, (1, 32, 32, 32, 256)) * F16_TINY * (rng.random((1, 32, 32, 32, 256)) < 0.1)
    dy = torch.from_numpy(dy).to(torch.float16)
    plan = conv3d_grad.dw_plan(1, 32, 32, 32, 128, 256, SMS)
    assert plan["splits"] == 5 and plan["tiles_per_split"] == 52 and plan["chain_steps"] == 16
    chains = _f16_chains(dy, plan["tiles_per_split"])
    assert 15 - math.frexp(7 * F16_TINY)[1] == 36
    for block_chains in chains:
        assert len(block_chains) == plan["tiles"] // 2
        assert all(end - first == 2 and k == 36 for first, end, k in block_chains)
