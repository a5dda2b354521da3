"""The training 3³ conv: forward, dx and dW each a hand-written kernel.

The port of ``pcmseg_tpu/ops/hybrid_conv.py::conv3x3_hybrid`` with
``dw_impl='pallas'``, as a ``torch.autograd.Function`` over NDHWC:

  * forward: ``conv3x3x3`` (kernel B1) with bias and no ReLU (BatchNorm
    follows the conv in training);
  * dx: B1 again, on ``dy`` with the weight spatially flipped and Ci↔Co
    transposed, no bias, no ReLU; computed only when x needs a gradient
    (not for the input conv, whose x is the image);
  * dW: ``conv3x3_dw`` (kernel B2), brought back to the (Co, Ci, 3, 3, 3)
    parameter layout in the parameter's dtype;
  * db: Σ dy in fp32, in the parameter's dtype.

Each kernel runs in x's dtype: bf16, fp16 or fp32 operands (``compute_dtype``),
whatever the parameters' dtype (``param_dtype``), from which the packed
weight is cast.

On CPU tensors every kernel wrapper runs its plain PyTorch version.
``conv3x3_plain`` is the plain version of the whole Function: autograd of
``F.conv3d`` in x's dtype, with the bias added in fp32 as B1 does.

``halo_conv`` runs a conv on one rank's D-slab of a spatially sharded
volume: on the slab with its neighbours' facing slices around it
(``collectives.halo_exchange``), keeping the output's inner slices. In
training its backward is the Function's own: dy zero-extended by the
slicing, dx through B1 on it and dW through B2 on the extended x; the
halos' cotangents go back to the neighbours.

Tensor parallelism: a conv whose output channels are sharded over the
model group is this same Function on the whole input, gathered from the
channel shards, with the rank's weight shard: the forward is B1 with
Co / tp, dW is B2 with the whole Ci and Co / tp, and dx is B1 on the dy
shard (Ci = Co / tp, zero-padded by ``ci_pad``), a partial sum that the
layer adds up over the model group (``collectives.ChannelShard.input``).
On a spatial × model mesh ``halo_conv`` exchanges the halo of the channel
shard and the gather runs inside ``conv`` on the extended slab: the halo
moves 1/tp of the bytes it would move after the gather, and the gathered
tensor is the conv's input as on a spatial mesh alone.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from pcmseg_tpu_torch.ops.kernels.conv3d import conv3x3x3, pack_weight, plain_dtype
from pcmseg_tpu_torch.ops.kernels.conv3d_grad import conv3x3_dw
from pcmseg_tpu_torch.parallel.collectives import Comm, halo_exchange


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, w_packed):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return conv3x3x3(x, w_packed, bias, relu=False)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if dy.is_cuda and weight.shape[1] % 8:
                # dx's output channels are the layer's Ci, which B1 takes only
                # in multiples of 8; the one such layer of the model (the
                # input conv) needs no dx
                raise RuntimeError(
                    f"dx of a conv with Ci={weight.shape[1]} (not a multiple of 8) is "
                    "not supported; the input of such a conv must not require grad"
                )
            w_t = pack_weight(weight.detach().flip(2, 3, 4).transpose(0, 1), dy.dtype)
            dx = conv3x3x3(dy, w_t, None, relu=False)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, dy).permute(4, 3, 0, 1, 2).to(weight.dtype).contiguous()
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2, 3), dtype=torch.promote_types(dy.dtype, torch.float32)).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, w_packed: torch.Tensor
) -> torch.Tensor:
    """Differentiable 3³ SAME conv + bias over NDHWC.

    Args:
      x: (N, D, H, W, Ci); bf16, fp16 or fp32 on CUDA.
      weight: (Co, Ci, 3, 3, 3) parameter (fp32, bf16 or fp16).
      bias: (Co,) parameter in the weight's dtype.
      w_packed: ``pack_weight(weight, x.dtype)``, the forward kernel's copy
        (gradients reach ``weight`` through the Function, not through it).
    Returns (N, D, H, W, Co) in x's dtype.
    """
    return _Conv3x3.apply(x, weight, bias, w_packed)


def conv3x3_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`conv3x3` (``w_packed`` is ignored). fp16 x
    is convolved in fp32 and rounded once, as ``conv3x3x3_reference``
    does, with the weight's values rounded to fp16 and its gradient left
    in fp32, as the Function leaves dW."""
    del w_packed
    w = weight.to(x.dtype)
    if plain_dtype(x.dtype) != x.dtype:
        wf = weight.float()
        w = wf + (w.float() - wf).detach()
    y = F.conv3d(x.to(w.dtype).permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    acc = torch.promote_types(x.dtype, torch.float32)
    return (y.to(acc) + bias.to(acc)).to(x.dtype).contiguous()


def halo_conv(conv: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``conv`` (a 3³ SAME conv over NDHWC) of the whole volume, on this
    rank's D-slab ``x`` of it: ``conv`` of the slab extended by one
    neighbouring slice on each side (zeros at the volume's ends), less its
    first and last output slices."""
    return conv(halo_exchange(x, comm))[:, 1:-1].contiguous()
