"""The all-reductions of data-parallel training. In JAX, GSPMD inserted
them where a reduction ran over a batch sharded on the 'data' axis; here
they are written out.

  * :func:`synchronized_batch` marks the code in which a reduction over the
    batch means over the global batch of every rank: the loss and the eval
    metrics sum through :func:`batch_sum` (``all_reduce_sum``), BatchNorm
    all-reduces its sums (``models/unet3d.py``). Outside it every
    reduction is this rank's own.
  * :func:`all_reduce_sum` is differentiable: its backward all-reduces the
    cotangent too. Every rank computes the same (replicated) loss from the
    summed statistics, so a rank seeds its backward with 1/world of it, and
    the summed parameter gradients are then the global loss's.
  * :class:`GradientAllReduce`: the gradients of every parameter, copied
    into one flat fp32 buffer in parameter order, summed by one collective
    a step and copied back. A fixed order and one collective keep the step
    deterministic and the result bitwise equal on every rank.
  * :func:`exchange`: the sum of contributions that are zero on all ranks
    but one element by element (rows written by their owner into a zeroed
    buffer), made exact by summing the bytes: every byte is added to
    zeros, so it arrives unchanged, whatever the dtype (gloo refuses int16
    and sums floats in their own arithmetic, where −0 + 0 is +0).

All of them run whenever this process is in a process group
(:func:`active`), a group of one rank included: there they are identities
that still go through the backend (the chip check runs a one-rank NCCL
group so). Without a group every reduction is this process's own.

The state of :func:`synchronized_batch` is process-wide, not per thread:
CUDA runs the backward (and a rematerialised block's forward within it)
on autograd's own threads.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from pcmseg_tpu_torch.parallel import multihost

_synchronized = [False]


def active() -> bool:
    """Whether this process is in a process group, and collectives run."""
    return dist.is_initialized()


@contextlib.contextmanager
def synchronized_batch(enabled: bool = True):
    """Reductions over the batch inside are global (in a process group,
    when ``enabled``)."""
    prev = _synchronized[0]
    _synchronized[0] = bool(enabled) and active()
    try:
        yield
    finally:
        _synchronized[0] = prev


def batch_synchronized() -> bool:
    return _synchronized[0]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank, differentiable (module docstring)."""
    return _AllReduceSum.apply(x)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's part of a batch, summed over every
    rank's part inside :func:`synchronized_batch`; ``x`` itself outside."""
    return all_reduce_sum(x) if _synchronized[0] else x


def backward_scale() -> float:
    """What a rank seeds the backward of a replicated loss with: 1/world
    inside :func:`synchronized_batch`, else 1."""
    return 1.0 / multihost.process_count() if _synchronized[0] else 1.0


def exchange(t: torch.Tensor) -> torch.Tensor:
    """In place and returned: the sum over every rank of ``t``, where each
    element is non-zero on one rank at most, bitwise (summed as bytes)."""
    if not active():
        return t
    if not t.is_contiguous():
        raise ValueError("exchange needs a contiguous tensor")
    dist.all_reduce(t.view(-1).view(torch.uint8))
    return t


class GradientAllReduce:
    """Sums the gradients of ``params`` over every rank with one all-reduce
    of a flat fp32 buffer, kept between steps."""

    def __init__(self, params: List[torch.nn.Parameter]):
        self.params = [p for p in params if p.requires_grad]
        self._flat: Optional[torch.Tensor] = None

    def __call__(self) -> None:
        if not active():
            return
        grads = [p.grad for p in self.params]
        if self._flat is None or self._flat.device != grads[0].device:
            self._flat = torch.empty(sum(g.numel() for g in grads), dtype=torch.float32, device=grads[0].device)
        offset = 0
        for g in grads:
            self._flat[offset: offset + g.numel()].copy_(g.reshape(-1))
            offset += g.numel()
        dist.all_reduce(self._flat)
        offset = 0
        for g in grads:
            g.copy_(self._flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
