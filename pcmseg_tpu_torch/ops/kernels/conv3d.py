"""Fused 3³ SAME conv + bias + ReLU over NDHWC: CUDA kernel and plain version.

``conv3x3x3`` replaces the Pallas TPU kernel
``pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3``. A CUDA tensor goes to the
hand-written ``sm_90a`` kernel (``csrc/conv3x3x3.cu``); a CPU tensor goes to
``conv3x3x3_reference``, the same function in plain PyTorch. There is no
fallback from one to the other.

Weights are packed once per load (``pack_weight``) from the module layout
(Co, Ci, 3, 3, 3) into the kernel's (Co, 27 * ci_pad(Ci)) GEMM matrix:
column ``tap * ci_pad(Ci) + ci`` with ``tap = (kd * 3 + kh) * 3 + kw``. The
kernel reads x in 64-channel chunks, or as one 8-channel slab: the channels
are padded with zeros to 8 (Ci <= 8, the 5-modality input conv) or to a
multiple of 64, in the packed weight and, by the wrapper, in x.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# kernel launches since the count was last set to 0 (CPU calls not counted)
launches = 0


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


def conv3x3x3_reference(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` in x's dtype on an NCDHW view,
    then bias in fp32 (float64 for a float64 x), ReLU, and a cast back to
    x's dtype."""
    w = unpack_weight(w_packed, x.shape[-1]).to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    acc = torch.promote_types(x.dtype, torch.float32)
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
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA kernel takes bf16 x and weight, got {x.dtype} / {w_packed.dtype}"
        )
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
      x: (N, D, H, W, Ci); bf16 on CUDA, any float dtype on the CPU.
      w_packed: ``pack_weight`` output in x's dtype.
      b: (Co,) fp32 bias, or None.
      relu: apply the ReLU in the epilogue.
    Returns (N, D, H, W, Co) in x's dtype.
    """
    if x.device.type == "cpu":
        return conv3x3x3_reference(x, w_packed, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    ws_bytes = lib.pcmseg_conv3x3x3_workspace_bytes(n, d, h, w, ci, co, dev)
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device) if ws_bytes else None
    rc = lib.pcmseg_conv3x3x3_bf16(
        x.data_ptr(), w_packed.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), None if workspace is None else workspace.data_ptr(), ws_bytes,
        n, d, h, w, ci, co, int(relu), torch.cuda.current_stream(x.device).cuda_stream, dev,
    )
    if rc != 0:
        raise RuntimeError(
            f"conv3x3x3 launch failed: {lib.pcmseg_cuda_error_string(rc).decode()} "
            f"(x {tuple(x.shape)}, Co={co})"
        )
    global launches
    launches += 1
    return out
