"""BatchNorm over the batch, and the ReLU after it, in training, over NDHWC:
CUDA kernels and plain version.

``batchnorm_train`` runs a training BatchNorm (with ``relu``, the ReLU that
follows it too). A CUDA tensor goes to the hand-written kernels of
``csrc/batchnorm_relu.cu`` (bf16, fp16 or fp32; four launches a layer: the
statistics, the apply with ReLU, the backward's sums, dx); what they cannot
take raises, with no fallback. A CPU tensor goes to ``batchnorm_train_reference``,
the plain PyTorch version (``BatchNormTrain``, then the running statistics
and ``torch.relu``), the arithmetic the JAX parity tests hold.

The kernels replace no Pallas kernel: the JAX package leaves BatchNorm and
ReLU to XLA, which fuses them into its neighbours (its Pallas
``fused_norm_relu.py`` was deleted unused, BENCH.md:308-317). They are bound
by bytes: 16 an element in bf16 (x read for the statistics, read again and y
written; x and dy read for the sums, read again and dx written), against
~122 for the plain version's ~30 ops and fp32 copies. Their design (one
16-byte vector of channels a thread for the whole launch, its mult and shift
in registers, fixed-order double sums with the cross-block sum in the last
block) is in the source's note.

With ``sync`` (inside ``collectives.synchronized_batch``) the batch is every
rank's part of it: the wrapper all-reduces (Σx, Σx²) between the statistics
and the apply, and (Σdy', Σdy'·(x − mean)) between the sums and dx, over the
ranks ``collectives.norm_scope`` names for the layer's ``level``, with the
count of their voxels. dγ and dβ stay this rank's sums: the gradient
all-reduce sums them once.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from pcmseg_tpu_torch.parallel import collectives

# kernel launches since the count was last set to 0 (CPU calls not counted):
# two a training forward, two a backward
launches = 0
_count_lock = threading.Lock()
# the kernels' entry code of each element dtype
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# the per-channel table a forward writes (8 x C fp32), by row: the batch's
# mean, variance and unbiased variance, r = (var + eps)^-½, the apply's mult
# and shift, and (Σx, Σx²) from 6; the rows read here
MEAN, UNBIASED, SUM = 0, 2, 6
# the channel slices the kernels' scratch has counters for (kMaxSlices), in
# 16-byte vectors of 128 bytes a row
MAX_SLICES = 1024
SLICE_VECTORS = 8
# a scratch buffer (the cross-block partials and their counters) for each
# (device, stream) the kernels run on, zeroed once: the kernels leave their
# counters at 0, and two launches on one stream never overlap
_scratch = {}
_scratch_lock = threading.Lock()


def _scope(x: torch.Tensor, sync: bool, level: int) -> Tuple[Optional[collectives.Comm], int]:
    """(the ranks whose sums are added to this rank's, or None; the voxels of the whole sum)."""
    voxels = x.numel() // x.shape[-1]
    return collectives.norm_scope(level, voxels, x.shape[1]) if sync else (None, voxels)


class BatchNormTrain(torch.autograd.Function):
    """The plain version: ``y = x·mult + shift`` with batch statistics;
    returns (y, mean, var).

    Statistics in fp32 over (N, D, H, W): mean and E[x²] − mean² clamped at
    0 (``norm.py:58-66``); the normalization in x's dtype. The backward is
    the analytic one, in fp32, saving only x in its own dtype.

    With ``sync`` the forward all-reduces (Σx, Σx²) before the mean and
    variance over the ranks that ``collectives.norm_scope`` names for
    ``level``, with the count of their voxels, and the backward all-reduces
    (Σdy, Σdy·(x − mean)) over the same ranks for dx only. ``scope``, where
    given, is ``_scope``'s (ranks, voxels) for this x, already resolved.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, sync=False, level=0, scope=None):
        dims = tuple(range(x.dim() - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        comm, n = scope if scope is not None else _scope(x, sync, level)
        if comm is not None:
            sums = comm.all_reduce(torch.stack([xf.sum(dims), xf.square().sum(dims)]))
            mean = sums[0] / n
            var = (sums[1] / n - mean.square()).clamp_min(0.0)
        else:
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
        r = torch.rsqrt(var + eps)
        mult = weight.to(mean.dtype) * r
        shift = bias.to(mean.dtype) - mean * mult
        ctx.save_for_backward(x, weight, mean, r, mult)
        ctx.comm, ctx.n = comm, n
        ctx.mark_non_differentiable(mean, var)
        return x * mult.to(x.dtype) + shift.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, r, mult = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        n = ctx.n
        dyf = dy.to(mean.dtype)
        xc = x.to(mean.dtype) - mean
        ds = dyf.sum(dims)  # dL/dshift
        dxc = (dyf * xc).sum(dims)  # Σ dy·(x − mean)
        ds_all, dxc_all = ds, dxc
        if ctx.comm is not None:
            ds_all, dxc_all = ctx.comm.all_reduce(torch.stack([ds, dxc]))
        # mult = γ·r, shift = β − mean·mult, r = (var + eps)^-½
        dvar = -0.5 * r.pow(3) * weight.to(mean.dtype) * dxc_all
        dx = dyf * mult + xc * (2.0 * dvar / n) - mult * ds_all / n
        return dx.to(x.dtype), (r * dxc).to(weight.dtype), ds.to(weight.dtype), None, None, None, None


def batchnorm_train_reference(x, weight, bias, eps: float, sync: bool = False, level: int = 0, relu: bool = False,
                              running=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ``batchnorm_train``, on any device: ``BatchNormTrain``,
    the unbiased variance, ``running.momentum_update`` where given, then
    ``torch.relu`` where ``relu``."""
    scope = _scope(x, sync, level)
    y, mean, var = BatchNormTrain.apply(x, weight, bias, eps, sync, level, scope)
    n = scope[1]
    unbiased = var * (n / max(n - 1, 1))
    if running is not None:
        running.momentum_update(mean, unbiased)
    return (torch.relu(y) if relu else y), mean, unbiased


def check_kernel_args(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running=None) -> None:
    """Raise on what the kernels do not take: an element dtype outside bf16 /
    fp16 / fp32, channels that are not whole 16-byte vectors or more than
    MAX_SLICES slices of them, an empty, strided or unaligned x, a γ or β of
    another shape or device, running statistics that are not (C,) fp32 (and
    an int64 batch count) on x's device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the BatchNorm kernels take bf16, fp16 or fp32 x, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"the BatchNorm kernels take a non-empty (..., C) tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec or -(-c // vec // SLICE_VECTORS) > MAX_SLICES:
        raise ValueError(f"the BatchNorm kernels need C % {vec} == 0 and C <= {MAX_SLICES * SLICE_VECTORS * vec} "
                         f"for {x.dtype}, got C={c}")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"{name} must be ({c},) on {x.device}, got {tuple(t.shape)} on {t.device}")
    if running is not None:
        stats = (running.running_mean, running.running_var)
        if (any(t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device or not t.is_contiguous()
                for t in stats) or running.num_batches_tracked.dtype != torch.int64
                or running.num_batches_tracked.device != x.device):
            raise ValueError(f"the running statistics must be ({c},) fp32 and the batch count int64, on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the BatchNorm kernels take a contiguous, 16-byte aligned x")


def _stream_scratch(device: torch.device, stream: int, lib) -> torch.Tensor:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        with _scratch_lock:
            buf = _scratch.get(key)
            if buf is None:
                buf = torch.zeros(lib.pcmseg_batchnorm_scratch_bytes(), dtype=torch.uint8, device=device)
                _scratch[key] = buf
    return buf


def _launched(lib, rc: int, what: str, x: torch.Tensor) -> None:
    """Raise on a launch's error code, else count the launch."""
    global launches
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.pcmseg_cuda_error_string(rc).decode()} "
                           f"(x {tuple(x.shape)} {x.dtype})")
    with _count_lock:
        launches += 1


class _BatchNormKernels(torch.autograd.Function):
    """``batchnorm_train`` on CUDA tensors: forward (statistics, all-reduce,
    apply) and backward (sums, all-reduce, dx) in the kernels. Saves x in
    its own dtype, γ and the (8, C) fp32 table."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, comm, n, relu, running):
        from pcmseg_tpu_torch.ops.kernels.build import load_library

        lib = load_library()
        m, c = x.numel() // x.shape[-1], x.shape[-1]
        code, dev = _DTYPES[x.dtype], x.device.index
        stream = torch.cuda.current_stream(x.device).cuda_stream
        scratch = _stream_scratch(x.device, stream, lib)
        table = torch.empty((8, c), dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        sums = table[SUM:]
        rc = lib.pcmseg_batchnorm_stats(code, x.data_ptr(), m, c, scratch.data_ptr(), scratch.numel(),
                                        sums.data_ptr(), stream, dev)
        _launched(lib, rc, "BatchNorm statistics", x)
        if comm is not None:
            comm.all_reduce(sums)
        gamma, beta = weight.detach().float(), bias.detach().float()
        move = (running.running_mean.data_ptr(), running.running_var.data_ptr(),
                running.num_batches_tracked.data_ptr()) if running is not None else (None, None, None)
        momentum = float(running.momentum) if running is not None else 0.0
        rc = lib.pcmseg_batchnorm_relu(code, x.data_ptr(), y.data_ptr(), m, c, sums.data_ptr(), gamma.data_ptr(),
                                       beta.data_ptr(), float(n), float(eps), int(relu), table.data_ptr(), *move,
                                       1.0 - momentum, momentum, n / max(n - 1, 1), stream, dev)
        _launched(lib, rc, "BatchNorm apply", x)
        ctx.save_for_backward(x, gamma, table)
        ctx.comm, ctx.n, ctx.relu, ctx.weight_dtype = comm, n, relu, weight.dtype
        mean, unbiased = table[MEAN], table[UNBIASED]
        ctx.mark_non_differentiable(mean, unbiased)
        return y, mean, unbiased

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from pcmseg_tpu_torch.ops.kernels.build import load_library

        lib = load_library()
        x, gamma, table = ctx.saved_tensors
        if dy.dtype != x.dtype:
            raise TypeError(f"BatchNorm backward: dy {dy.dtype} for x {x.dtype}")
        dy = dy.contiguous()
        m, c = x.numel() // x.shape[-1], x.shape[-1]
        code, dev = _DTYPES[x.dtype], x.device.index
        stream = torch.cuda.current_stream(x.device).cuda_stream
        scratch = _stream_scratch(x.device, stream, lib)
        out = torch.empty((4, c), dtype=torch.float32, device=x.device)
        rc = lib.pcmseg_batchnorm_grad_sums(code, x.data_ptr(), dy.data_ptr(), m, c, table.data_ptr(),
                                            int(ctx.relu), scratch.data_ptr(), scratch.numel(), out.data_ptr(),
                                            stream, dev)
        _launched(lib, rc, "BatchNorm backward sums", x)
        sums = out[:2]
        if ctx.comm is not None:
            ctx.comm.all_reduce(sums)
        dx = torch.empty_like(x)
        rc = lib.pcmseg_batchnorm_dx(code, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), m, c, table.data_ptr(),
                                     gamma.data_ptr(), sums.data_ptr(), float(ctx.n), int(ctx.relu), stream, dev)
        _launched(lib, rc, "BatchNorm dx", x)
        return dx, out[2].to(ctx.weight_dtype), out[3].to(ctx.weight_dtype), None, None, None, None, None


def batchnorm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, sync: bool = False,
                    level: int = 0, relu: bool = False, running=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A training BatchNorm of x (..., C) over every axis but the last, then
    ``relu``'s ReLU: returns (y, the batch mean, the unbiased batch
    variance), the two (C,) fp32 and not differentiable.

    Args:
      x: (..., C); bf16, fp16 or fp32 on CUDA, any float dtype on the CPU.
      weight, bias: γ and β (C,), in the parameters' dtype.
      sync, level: a synchronised batch's BatchNorm at U-Net ``level``
        (module docstring).
      relu: apply the ReLU that follows the norm, and mask its gradient.
      running: the module whose running statistics move by its momentum
        toward the batch mean and unbiased variance (``running_mean``,
        ``running_var``, ``num_batches_tracked``, ``momentum`` and
        ``momentum_update``); None leaves them alone.
    Returns y in x's dtype.
    """
    if x.device.type == "cpu":
        return batchnorm_train_reference(x, weight, bias, eps, sync, level, relu, running)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    check_kernel_args(x, weight, bias, running)
    comm, n = _scope(x, sync, level)
    return _BatchNormKernels.apply(x, weight, bias, eps, comm, n, relu, running)
