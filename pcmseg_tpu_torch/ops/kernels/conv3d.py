"""Fused 3³ SAME conv + bias + ReLU over NDHWC: CUDA kernel and plain version.

``conv3x3x3`` replaces the Pallas TPU kernel
``pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3``, which computes in x's dtype,
bf16, fp16 or fp32. A CUDA tensor goes to a hand-written ``sm_90a`` kernel
of its dtype: bf16 and fp16 x and weight to ``csrc/conv3x3x3.cu`` (wgmma,
one template, an entry point each), fp32 x and weight to
``csrc/conv3x3x3_f32.cu`` (3xTF32 wgmma: each operand split as
``tf32_split`` splits it, the three products hi·hi, hi·lo and lo·hi, fp32's
accuracy on the tensor cores; the wrapper splits the packed weight, the
kernel x); a CPU tensor goes to ``conv3x3x3_reference``, the same function
in plain PyTorch.
There is no fallback from one to the other. x and the packed weight share a
dtype on every device; the bias is fp32 (another float dtype is cast to it,
as the Pallas wrapper casts it).

Weights are packed once per load (``pack_weight``) from the module layout
(Co, Ci, 3, 3, 3) into the kernel's (Co, 27 * ci_pad(Ci)) GEMM matrix:
column ``tap * ci_pad(Ci) + ci`` with ``tap = (kd * 3 + kh) * 3 + kw``. The
16-bit kernels read x in 64-channel chunks and the fp32 kernel in 32-channel
chunks, each or as one 8-channel slab: for both the channels are padded
with zeros to 8 (Ci <= 8, the 5-modality input conv) or to a multiple of
64, in the packed weight and, by the wrapper, in x.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# kernel launches since the count was last set to 0 (CPU calls not counted),
# of the bf16 kernel (``launches``), the fp32 one (``launches_f32``) and the
# fp16 one (``launches_f16``); a sharded Predictor launches from one thread a
# shard
launches = 0
launches_f32 = 0
launches_f16 = 0
_count_lock = threading.Lock()
# the C entry point of each operand dtype's kernel, of its workspace size,
# and the counter of its launches
_ENTRY = {torch.bfloat16: "pcmseg_conv3x3x3_bf16", torch.float16: "pcmseg_conv3x3x3_f16",
          torch.float32: "pcmseg_conv3x3x3_f32"}
_WORKSPACE = {torch.bfloat16: "pcmseg_conv3x3x3_workspace_bytes",
              torch.float16: "pcmseg_conv3x3x3_f16_workspace_bytes",
              torch.float32: "pcmseg_conv3x3x3_f32_workspace_bytes"}
_COUNTER = {torch.bfloat16: "launches", torch.float16: "launches_f16", torch.float32: "launches_f32"}


def _tf32(a: torch.Tensor) -> torch.Tensor:
    bits = a.view(torch.int32)
    # int32 arithmetic on the bit pattern: adding half of the dropped 13
    # bits' unit to the magnitude and truncating rounds ties away from zero
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(a), a, rounded)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``a`` as the fp32 kernels split their operands:
    ``hi = tf32(a)``, ``lo = tf32(a - hi)``, where tf32 is PTX's
    ``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
    mantissa bits (the low 13 bits of the fp32 word zero). ``a - hi`` is
    exact in fp32, and ``hi + lo`` is within 2^-21 |a| of a."""
    if a.dtype != torch.float32:
        raise TypeError(f"tf32_split takes fp32, got {a.dtype}")
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def ci_pad(ci: int) -> int:
    """The channel count the kernels read: 8 for Ci <= 8, else Ci rounded up to 64."""
    return 8 if ci <= 8 else -(-ci // 64) * 64


def packed_k(ci: int) -> int:
    return 27 * ci_pad(ci)


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """x (..., Ci) with its channels zero-padded to ci_pad(Ci) (x itself if none)."""
    ci = x.shape[-1]
    return x if ci == ci_pad(ci) else F.pad(x, (0, ci_pad(ci) - ci)).contiguous()


def pack_weight(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) conv weight -> (Co, packed_k(Ci)) packed matrix."""
    if weight.dim() != 5 or tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a (Co, Ci, 3, 3, 3) weight, got {tuple(weight.shape)}")
    co, ci = weight.shape[:2]
    packed = weight.new_zeros((co, 27, ci_pad(ci)), dtype=dtype or weight.dtype)
    packed[:, :, :ci] = weight.permute(0, 2, 3, 4, 1).reshape(co, 27, ci)
    return packed.reshape(co, packed_k(ci))


def unpack_weight(packed: torch.Tensor, ci: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight` -> (Co, Ci, 3, 3, 3)."""
    co = packed.shape[0]
    return packed.reshape(co, 27, ci_pad(ci))[:, :, :ci].reshape(co, 3, 3, 3, ci).permute(0, 4, 1, 2, 3)


def plain_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions convolve ``dtype`` operands in: their
    own, but fp16 in fp32. PyTorch rounds an fp16 conv's sums to fp16; the
    kernels (and the Pallas ones) sum the exact products of fp16 values in
    fp32 and round once, which fp32 operands give."""
    return torch.float32 if dtype == torch.float16 else dtype


def conv3x3x3_reference(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` in x's dtype on an NCDHW view,
    then bias in fp32 (float64 for a float64 x), ReLU, and a cast back to
    x's dtype. fp16 runs the conv in fp32 (``plain_dtype``), so that the
    sum is rounded to fp16 once, as the kernel rounds it."""
    acc = torch.promote_types(x.dtype, torch.float32)
    work = plain_dtype(x.dtype)
    w = unpack_weight(w_packed, x.shape[-1]).to(work)
    y = F.conv3d(x.to(work).permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    y = y.to(acc)
    if b is not None:
        y = y + b.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def _check_cuda_args(x, w_packed, b):
    if x.dim() != 5:
        raise ValueError(f"x must be (N, D, H, W, Ci), got {tuple(x.shape)}")
    ci = x.shape[-1]
    if w_packed.dim() != 2 or w_packed.shape[1] != packed_k(ci):
        raise ValueError(
            f"packed weight must be (Co, {packed_k(ci)}) for Ci={ci}, "
            f"got {tuple(w_packed.shape)}"
        )
    co = w_packed.shape[0]
    if co % 8:
        raise ValueError(f"the CUDA kernel needs Co % 8 == 0, got Co={co}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the CUDA kernels take bf16, fp16 or fp32 x and weight, got {x.dtype}")
    tensors = [x, w_packed]
    if b is not None:
        if b.dtype != torch.float32 or tuple(b.shape) != (co,):
            raise ValueError(f"bias must be fp32 ({co},), got {b.dtype} {tuple(b.shape)}")
        tensors.append(b)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned x and weight")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def conv3x3x3(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """``max(conv3d_same(x, W) + b, 0)`` over NDHWC.

    Args:
      x: (N, D, H, W, Ci); bf16, fp16 or fp32 on CUDA, any float dtype on the CPU.
      w_packed: ``pack_weight`` output in x's dtype.
      b: (Co,) bias, or None; added in fp32 (float64 for a float64 x on the CPU).
      relu: apply the ReLU in the epilogue.
    Returns (N, D, H, W, Co) in x's dtype.
    """
    if x.dtype != w_packed.dtype:
        raise TypeError(f"x and the packed weight must share a dtype, got {x.dtype} / {w_packed.dtype}")
    if x.device.type == "cpu":
        return conv3x3x3_reference(x, w_packed, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if b is not None and b.dtype != torch.float32 and b.dtype.is_floating_point:
        b = b.float()  # as the Pallas wrapper's b.astype(jnp.float32)
    _check_cuda_args(x, w_packed, b)
    from pcmseg_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    x = pad_channels(x)
    n, d, h, w, ci = x.shape
    co = w_packed.shape[0]
    dev = x.device.index
    out = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
    # fp32 split-K partials, for the deep layers whose output alone is too
    # few tiles to fill the card
    ws_bytes = getattr(lib, _WORKSPACE[x.dtype])(n, d, h, w, ci, co, dev)
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device) if ws_bytes else None
    # the fp32 kernel reads the weight as its (hi, lo) TF32 pair
    weight = torch.stack(tf32_split(w_packed)) if x.dtype == torch.float32 else w_packed
    rc = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), weight.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), None if workspace is None else workspace.data_ptr(), ws_bytes,
        n, d, h, w, ci, co, int(relu), torch.cuda.current_stream(x.device).cuda_stream, dev,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv3x3x3 launch failed: {lib.pcmseg_cuda_error_string(rc).decode()} "
            f"(x {tuple(x.shape)}, Co={co})"
        )
    with _count_lock:
        globals()[_COUNTER[x.dtype]] += 1
    return out
