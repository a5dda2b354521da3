"""The 16-bit weight-gradient kernel's summation order, on the CPU.

``csrc/conv3x3_dw.cu`` sums each dW element over up to 2.1 M voxels. The
tensor cores' fp32 sums do not round to nearest: on an NVIDIA H100 a chain
of k16 steps into one accumulator loses in proportion to its length, and
the kernel used to run one chain over a whole split-K slice (up to 5,960
steps). It now cuts every chain to ``conv3d_grad.dw_plan``'s
``chain_steps`` and adds the chains into running totals with FADDs.

Here: ``dw_plan`` against the plan the C code computes (``make_dw_plan``) at
every flagship shape; a numpy emulation of the kernel's summation order on
same-sign inputs (where every element is its own sum of |x·dy|, so its
relative error is what the order loses) over every voxel of the layer, old
order against the card's reading and new order against the bound that
``chip_smoke.py``'s ``dw_sum`` phase holds the kernel to; and the JAX
kernel's own accuracy on same-sign inputs, which the new order restores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.ops.pallas import conv3d_grad as jax_dw
from pcmseg_tpu_torch.ops.kernels import conv3d_grad

SMS = 132  # an H100 SXM
# the longest tensor-core chain the kernel may run (k16 steps)
CHAIN_LIMIT = 32
# what chip_smoke.py's dw_sum phase allows a same-sign element, relative to
# its sum
SAME_SIGN_BOUND = 2e-5
# the same-sign error of the kernel's earlier order, one chain a split, at
# 64->64 @128^3 (chains of 2,984 k16 steps), relative to Σ|x·dy|: 3.7e-4 at
# a GroupNorm layer of the K = 3 model, and 2.55e-4 on |normal| inputs
# (tools/probe_torch_kernels.py --time, NVIDIA H100 80GB HBM3, 700 W)
CARD_OLD_ORDER = (3.7e-4, 2.55e-4)

# (Ci, Co, size, splits, a split's k16 steps) of every B2 shape of the
# flagship model at 132 SMs, as make_dw_plan plans it
FLAGSHIP = (
    (5, 64, 128, 132, 1000), (64, 64, 128, 44, 2984), (128, 64, 128, 22, 5960),
    (64, 128, 64, 22, 752), (128, 128, 64, 11, 1496), (256, 128, 64, 5, 3280),
    (128, 256, 32, 5, 416), (256, 256, 32, 2, 1024), (512, 256, 32, 1, 2048),
    (256, 512, 16, 1, 256), (512, 512, 16, 1, 256), (1024, 512, 16, 1, 256),
    (512, 1024, 8, 1, 32), (1024, 1024, 8, 1, 32),
)
IDS = [f"{ci}-{co}@{s}" for ci, co, s, *_ in FLAGSHIP]


@pytest.mark.parametrize("ci,co,size,splits,split_steps", FLAGSHIP, ids=IDS)
def test_dw_plan_at_flagship_shapes(ci, co, size, splits, split_steps):
    plan = conv3d_grad.dw_plan(1, size, size, size, ci, co, SMS)
    assert plan["splits"] == splits
    assert plan["tiles_per_split"] * conv3d_grad.DW_STEPS_PER_TILE == split_steps
    assert plan["tiles"] == (size // 2) * (size // 8) ** 2 and -(-plan["tiles"] // plan["tiles_per_split"]) == splits
    kernel_ci = 8 if ci <= 8 else ci
    # the split partials alone, in bf16 and fp16 alike (fp16 finds its dy scales on chip)
    assert plan["workspace_bytes"] == (splits * 27 * kernel_ci * co * 4 if splits > 1 else 0)
    assert plan["chain_steps"] == min(split_steps, conv3d_grad.DW_STEPS_PER_TILE * conv3d_grad.DW_CHAIN_TILES)
    assert plan["chain_steps"] <= CHAIN_LIMIT


def _round_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounding toward zero."""
    f = v.astype(np.float32)
    past = np.abs(f.astype(np.float64)) > np.abs(v)
    f[past] = np.nextafter(f[past], np.float32(0))
    return f


def _groups(size: int, taps, seed: int) -> tuple:
    """Same-sign bf16 x and dy channels, one pair a dW element (one a tap of
    ``taps``), over a size^3 volume: (the k4 sums of each element's
    products in the kernel's order, (elements, tiles, 8 k16 steps, 4)
    float64; each element's exact sum)."""
    rng = np.random.default_rng(seed)
    tz, ty, tx = conv3d_grad.DW_TILE
    out, exact = [], []
    for kd, kh, kw in taps:
        x, dy = (torch.from_numpy(np.abs(rng.standard_normal(shape, dtype=np.float32)))
                 .to(torch.bfloat16).double().numpy() for shape in ((size + 2,) * 3, (size,) * 3))
        p = x[kd:kd + size, kh:kh + size, kw:kw + size] * dy  # exact: two 8-bit significands
        # tiles (z, y, x) in the kernel's order; in a tile, k16 step j =
        # 4 zz + q holds the two y rows 2q, 2q + 1 (r) of z plane zz, K = 8 r + x
        p = p.reshape(size // tz, tz, size // ty, 4, 2, size // tx, tx).transpose(0, 2, 5, 1, 3, 4, 6)
        out.append(p.reshape(-1, conv3d_grad.DW_STEPS_PER_TILE, 4, 4).sum(-1))
        exact.append(p.sum())
    return np.stack(out), np.array(exact)


def _emulate(groups: np.ndarray, splits: int, per_split: int, chain_steps: int) -> np.ndarray:
    """The kernel's sums of ``groups``: each split's tiles in order, each
    k4 sum added to a tensor-core accumulator rounding toward zero (four a
    k16 step, the card's loss), a fresh accumulator every ``chain_steps``
    steps added to the split's fp32 running total (rounding to nearest),
    the split partials added in split order."""
    elements, tiles = groups.shape[:2]
    padded = np.zeros((elements, splits * per_split) + groups.shape[2:])
    padded[:, :tiles] = groups
    steps = padded.reshape(elements, splits, per_split * conv3d_grad.DW_STEPS_PER_TILE, 4)
    total = np.zeros((elements, splits), np.float32)
    acc = np.zeros_like(total)
    for k in range(steps.shape[2]):
        for q in range(4):
            acc = _round_toward_zero(acc.astype(np.float64) + steps[:, :, k, q])
        if (k + 1) % chain_steps == 0 or k + 1 == steps.shape[2]:
            total = total + acc
            acc = np.zeros_like(total)
    out = total[:, 0]
    for s in range(1, splits):
        out = out + total[:, s]
    return out


# a corner, the centre and two edge taps
TAPS = ((0, 0, 0), (1, 1, 1), (2, 1, 0), (2, 2, 2))


def test_emulated_old_order_matches_the_card():
    """64->64 @128^3 summed in the kernel's earlier order, one chain a split
    (2,984 k16 steps), lands within 2x of the card's readings. A model that
    truncates once a k16 step (the step's exact sum) loses 4x less than the
    card does, so the model truncates four k4 sums a step."""
    plan = conv3d_grad.dw_plan(1, 128, 128, 128, 64, 64, SMS)
    groups, exact = _groups(128, TAPS, seed=0)
    split_steps = plan["tiles_per_split"] * conv3d_grad.DW_STEPS_PER_TILE
    old = np.abs(_emulate(groups, plan["splits"], plan["tiles_per_split"], split_steps) / exact - 1).max()
    for card in CARD_OLD_ORDER:
        assert card / 2 <= old <= 2 * card, (old, card)
    once = groups.sum(-1, keepdims=True)  # one truncation a k16 step
    once = np.concatenate([once, np.zeros(once.shape[:-1] + (3,))], -1)
    once_err = np.abs(_emulate(once, plan["splits"], plan["tiles_per_split"], split_steps) / exact - 1).max()
    assert once_err < min(CARD_OLD_ORDER) / 2, once_err


@pytest.mark.parametrize("ci,co,size,splits,split_steps", FLAGSHIP, ids=IDS)
def test_emulated_new_order_within_bound(ci, co, size, splits, split_steps):
    plan = conv3d_grad.dw_plan(1, size, size, size, ci, co, SMS)
    groups, exact = _groups(size, TAPS[:2], seed=ci * 7 + co + size)
    new = _emulate(groups, plan["splits"], plan["tiles_per_split"], plan["chain_steps"])
    err = np.abs(new / exact - 1).max()
    assert err <= SAME_SIGN_BOUND, err
    # and below what the old order loses where its chains are long
    old_chain = plan["tiles_per_split"] * conv3d_grad.DW_STEPS_PER_TILE
    if old_chain >= 1000:
        old = _emulate(groups, plan["splits"], plan["tiles_per_split"], old_chain)
        assert err < np.abs(old / exact - 1).max() / 10


@pytest.mark.parametrize("n,spatial,ci,co", [(1, (6, 8, 8), 8, 16), (2, (4, 6, 10), 16, 8)])
def test_jax_kernel_same_sign_accuracy(n, spatial, ci, co):
    """The Pallas kernel (interpret mode) on same-sign bf16 inputs: each
    grid step's fp32 dot added into the resident fp32 block once, within
    1e-6·Σ|x·dy| of float64, the accuracy the short chains restore."""
    rng = np.random.default_rng(ci + co)
    x, dy = (np.abs(rng.standard_normal((n, *spatial, c), dtype=np.float32)) for c in (ci, co))
    x16, dy16 = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    got = np.asarray(jax_dw.conv3x3_dw(x16, dy16, interpret=True), np.float64)
    exact = conv3d_grad.conv3x3_dw_reference(torch.from_numpy(np.asarray(x16, np.float64)),
                                             torch.from_numpy(np.asarray(dy16, np.float64))).numpy()
    assert np.abs(got / exact - 1).max() <= 1e-6
