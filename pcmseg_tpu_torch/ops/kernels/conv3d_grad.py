"""Weight gradient of the 3³ SAME conv over NDHWC: CUDA kernel and plain version.

``conv3x3_dw`` replaces the Pallas TPU kernel
``pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw``, which takes x and dy
in one float dtype. A CUDA tensor goes to a hand-written ``sm_90a`` kernel
of its dtype: bf16 and fp16 to ``csrc/conv3x3_dw.cu`` (wgmma, one template,
an entry point each; split-K partials summed in a fixed order), fp32 to
``csrc/conv3x3_dw_f32.cu`` (3xTF32 wgmma, x and dy split in the kernel as
``conv3d.tf32_split`` splits them); a CPU tensor goes to
``conv3x3_dw_reference``, the same function in plain PyTorch.
There is no fallback from one to the other; x and dy share a dtype on every
device. The kernels read x's channels padded with zeros as the forward
kernels do (``conv3d.ci_pad``); the wrapper pads x and returns the rows of
the real channels. ``dw_plan`` mirrors the 16-bit kernel's launch plan
(split-K, workspace, the longest tensor-core chain) for tests and tools.

The fp16 entry point sums each tensor-core chain's dy·2^k in place of dy
and multiplies the chain's sum by 2^-k as it adds it into dW, k =
``f16_scale_exponent`` of the chain's max|dy|, found on the card in shared
memory (both steps exact): on an H100 the tensor cores align a sum's
products with a subnormal fp16 operand as if it were normal at 2^-14,
cutting bits its leading zeros push below the alignment window, and an fp16
step's dy is nearly all zero or subnormal (no loss scaling).
"""

from __future__ import annotations

import math

import torch

from pcmseg_tpu_torch.ops.kernels.conv3d import ci_pad, pad_channels, plain_dtype

# kernel launches since the count was last set to 0 (CPU calls not counted),
# of the bf16 kernel (``launches``), the fp32 one (``launches_f32``) and the
# fp16 one (``launches_f16``)
launches = 0
launches_f32 = 0
launches_f16 = 0
# the C entry point of each operand dtype's kernel, of its workspace size,
# and the counter of its launches
_ENTRY = {torch.bfloat16: "pcmseg_conv3x3_dw_bf16", torch.float16: "pcmseg_conv3x3_dw_f16",
          torch.float32: "pcmseg_conv3x3_dw_f32"}
_WORKSPACE = {torch.bfloat16: "pcmseg_conv3x3_dw_workspace_bytes",
              torch.float16: "pcmseg_conv3x3_dw_workspace_bytes",
              torch.float32: "pcmseg_conv3x3_dw_f32_workspace_bytes"}
_COUNTER = {torch.bfloat16: "launches", torch.float16: "launches_f16", torch.float32: "launches_f32"}


# the 16-bit kernel's plan (csrc/conv3x3_dw.cu make_dw_plan): voxel tiles of
# 2x8x8 (z, y, x), eight k16 steps each; 64 x 64 channels a block; at least
# this many tiles a split; the tiles one tensor-core chain spans
DW_TILE = (2, 8, 8)
DW_STEPS_PER_TILE = 8
DW_BLOCK = 64
DW_MIN_TILES_PER_SPLIT = 4
DW_CHAIN_TILES = 2


# fp16 dy is summed as dy·2^k with max|dy|·2^k in [2^(F16_SCALE_TOP - 1),
# 2^F16_SCALE_TOP): below 65504, and no lower than a power of two allows
F16_SCALE_TOP = 15


def f16_scale_exponent(amax: float) -> int:
    """The exponent k of the fp16 kernel's dy scale for a chain's max|dy| =
    ``amax`` (the C ``f16_scale_exponent``, which computes it on the card
    from max|dy|'s fp16 bits): max|dy|·2^k in [2^14, 2^15); 0 for a zero,
    inf or NaN maximum and for max|dy| >= 2^14. Scaling an fp16 value up by
    2^k is exact while the result stays below 65504, and so is a chain's
    fp32 sum times 2^-k (k <= 38; a nonzero sum of fp16 products is a
    multiple of 2^-48)."""
    if amax == 0 or not math.isfinite(amax):
        return 0
    return max(0, F16_SCALE_TOP - math.frexp(amax)[1])


def dw_plan(n: int, d: int, h: int, w: int, ci: int, co: int, sms: int) -> dict:
    """The bf16 / fp16 kernel's launch plan for x (n, d, h, w, ci) and dy
    (..., co) on a card of ``sms`` SMs, as ``make_dw_plan`` computes it (ci
    is padded to what the kernel reads, ``conv3d.ci_pad``): ``tiles`` (of
    DW_TILE voxels, in the kernel's order), ``splits`` of them over
    gridDim.z, ``tiles_per_split``, ``workspace_bytes`` of fp32 split
    partials (the C ``pcmseg_conv3x3_dw_workspace_bytes``, fp16 and bf16
    alike), and ``chain_steps``, the most k16 steps any tensor-core sum runs
    before its add into a running total (DW_CHAIN_TILES tiles; a split's
    slice is tiles_per_split · 8 steps)."""
    ci = ci_pad(ci)
    tz, ty, tx = DW_TILE
    tiles = n * -(-d // tz) * -(-h // ty) * -(-w // tx)
    blocks = (1 if ci == 8 else 3 * (ci // DW_BLOCK)) * -(-co // DW_BLOCK)
    splits = max(1, min(sms // blocks, tiles // DW_MIN_TILES_PER_SPLIT)) if blocks < sms else 1
    per_split = -(-tiles // splits)
    splits = -(-tiles // per_split)
    return {"ci": ci, "tiles": tiles, "splits": splits, "tiles_per_split": per_split,
            "workspace_bytes": splits * 27 * ci * co * 4 if splits > 1 else 0,
            "chain_steps": DW_STEPS_PER_TILE * min(per_split, DW_CHAIN_TILES)}


def conv3x3_dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.nn.grad.conv3d_weight`` in x's dtype
    (fp16 in fp32, ``conv3d.plain_dtype``) on NCDHW views, returned as
    (3, 3, 3, Ci, Co) in fp32 (float64 for a float64 x)."""
    ci, co = x.shape[-1], dy.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    work = plain_dtype(x.dtype)
    gw = torch.nn.grad.conv3d_weight(
        x.to(work).permute(0, 4, 1, 2, 3), (co, ci, 3, 3, 3), dy.to(work).permute(0, 4, 1, 2, 3), padding=1
    )
    return gw.to(acc).permute(2, 3, 4, 1, 0).contiguous()


def _check_cuda_args(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 5 or dy.dim() != 5 or x.shape[:4] != dy.shape[:4]:
        raise ValueError(
            f"x (N, D, H, W, Ci) and dy (N, D, H, W, Co) must share N, D, H, W; "
            f"got {tuple(x.shape)} and {tuple(dy.shape)}"
        )
    if x.dtype not in _ENTRY:
        raise TypeError(f"the CUDA kernels take bf16, fp16 or fp32 x and dy, got {x.dtype}")
    co = dy.shape[-1]
    if co % 8:
        raise ValueError(f"the CUDA kernel needs Co % 8 == 0, got Co={co}")
    if dy.device != x.device:
        raise ValueError(f"x and dy must be on one device, got {x.device} and {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned x and dy")
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)} / {tuple(dy.shape)}")
    if x.shape[:4].numel() >= 2**31:
        raise ValueError(f"the CUDA kernel takes fewer than 2^31 voxels, got {tuple(x.shape)}")


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dW`` of ``y = conv3d_same(x, W)`` given ``dy``.

    Args:
      x: (N, D, H, W, Ci) forward input; bf16, fp16 or fp32 on CUDA, any
        float dtype on the CPU.
      dy: (N, D, H, W, Co) output gradient in x's dtype.
    Returns (3, 3, 3, Ci, Co) fp32 (the JAX kernel's layout; float64 for a
    float64 x on the CPU), summed over every voxel of the batch.
    """
    if x.dtype != dy.dtype:
        raise TypeError(f"x and dy must share a dtype, got {x.dtype} / {dy.dtype}")
    if x.device.type == "cpu":
        return conv3x3_dw_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, dy)
    from pcmseg_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    real_ci = x.shape[-1]
    x = pad_channels(x)
    n, d, h, w, ci = x.shape
    co = dy.shape[-1]
    dev = x.device.index
    out = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    # fp32 split-K partials, for the layers whose (27·Ci, Co) output alone is
    # too few tiles to fill the card; for fp16 also max|dy|
    ws_bytes = getattr(lib, _WORKSPACE[x.dtype])(n, d, h, w, ci, co, dev)
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device) if ws_bytes else None
    rc = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), dy.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(), ws_bytes,
        n, d, h, w, ci, co, torch.cuda.current_stream(x.device).cuda_stream, dev,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv3x3_dw launch failed: {lib.pcmseg_cuda_error_string(rc).decode()} "
            f"(x {tuple(x.shape)}, Co={co})"
        )
    globals()[_COUNTER[x.dtype]] += 1
    return out if ci == real_ci else out[:, :, :, :real_ci].contiguous()
