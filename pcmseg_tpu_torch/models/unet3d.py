"""4-level 3D U-Net in PyTorch, NDHWC, for serving and training.

The port of ``pcmseg_tpu/models/unet3d.py`` and ``pcmseg_tpu/models/norm.py``.
Module names follow the reference PyTorch model, so a
``params_to_torch_state_dict`` export loads with ``strict=True``:

  ``inc.conv.{0,3}``, ``down{i}.maxpool_conv.1.conv.{0,3}``, ``up{i}.up``,
  ``up{i}.conv.conv.{0,3}``, ``outc``; BatchNorm (or GroupNorm: ``weight``
  and ``bias`` only) at ``.1`` / ``.4``.

Tensors are channels-last (N, D, H, W, C) as in the JAX package. Every 3³
conv goes through ``ops.kernels.conv3d.conv3x3x3``: the hand-written CUDA
kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor. With
``norm_layer='none'`` (the BN-folded serving graph) the ReLU is fused into
the kernel's epilogue. With grad enabled a conv runs
``ops.hybrid_conv.conv3x3``, whose backward is the kernels too (dx and dW).
A training BatchNorm and the ReLU after it run as one layer
(``ops.kernels.batchnorm``: hand-written CUDA kernels for a CUDA tensor).
Max-pool, the 2³ stride-2 transposed conv, pad-align, concat, BatchNorm in
eval, GroupNorm (``norm_layer='group'``, ``min(group_norm_groups,
features)`` groups, as ``unet3d.py:247-253``) and the 1×1×1 head are stock
PyTorch, as the JAX package leaves them to XLA.
With ``remat`` the blocks (``inc``, ``down1-4``, ``up1-4``) are recomputed
in the backward (``torch.utils.checkpoint``), as ``nn.remat`` does in JAX.
With ``deep_supervision`` (training only) three more 1×1×1 heads, ``ds1``,
``ds2``, ``ds3``, read the outputs of ``up1``, ``up2`` and ``up3``
(``unet3d.py:458-495``); they are not in the reference layout, and the
``.pth`` export drops them.

Parameters are in ``param_dtype`` (fp32 by default; bf16 or fp16 as JAX's
``param_dtype``), BatchNorm's running statistics fp32 whatever it is (as
``norm.py:47-52`` keeps them); activations run in ``dtype`` (bf16 by
default, fp16 or fp32), each parameter cast to it where a layer uses it;
norms compute their statistics in fp32 and save their input in ``dtype``;
the logits come back fp32. fp16 activations overflow to ±inf past 65504
and keep their subnormals, as JAX's do: there is no loss scaling, as JAX
has none.

Spatial parallelism: under a ``collectives.spatial`` plan the forward runs
on this rank's D-slab of the volume. Every module knows its U-Net level
(``level``: 0 at full resolution, 4 at the bottleneck). At a level the
plan shards, a 3³ conv runs on its slab with the neighbours' facing
slices around it (``ops.hybrid_conv.halo_conv``), and GroupNorm sums its
per-sample statistics over the slabs. ``Down`` gathers the whole D
(``collectives.gather_d``) before pooling into the first level the plan
runs replicated, and ``Up`` pads its upsampled whole volume to the
level's global shape and keeps this rank's slab where it rejoins a
sharded level. BatchNorm sums over the ranks ``collectives.norm_scope``
names: with those of the other slabs at a sharded level, without them
where the statistics are already whole.

Tensor parallelism: ``parallel.sharding.shard_model`` cuts a model to one
rank's output-channel shards of every conv, transposed conv, head and norm
whose channels the model group's size divides (JAX's rule by shape) and
gives each a ``collectives.ChannelShard``. A sharded layer's output is the
rank's channel shard; BatchNorm, GroupNorm (over the model group where a
group spans the shards), ReLU and max-pooling run on the shard; a layer
reads the whole of its input, gathered from the shards where it is one
(``ChannelShard.input``: after the halo exchange, which so moves the shard
only), and ``Up`` gathers its skip and its upsampled half before the
concat. The heads' logits are whole on every rank.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcmseg_tpu_torch.parallel import collectives
from pcmseg_tpu_torch.ops.hybrid_conv import conv3x3 as conv3x3_train, halo_conv
from pcmseg_tpu_torch.ops.kernels.batchnorm import batchnorm_train
from pcmseg_tpu_torch.ops.kernels.conv3d import conv3x3x3, pack_weight

MIN_INPUT_SIZE = 16  # four 2x max-pools
NORM_LAYERS = ("batch", "group", "none")

# the compute dtypes the port's kernels take, and the parameter dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``. JAX takes any name
    ``jnp.dtype`` takes (``unet3d.py:528``); a dtype the port's kernels do
    not compute in (float64, ...) raises ``NotImplementedError`` naming
    it."""
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port's conv kernels compute in {', '.join(DTYPES)}")
    return DTYPES[name]


def param_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype``; one outside
    ``PARAM_DTYPES`` raises ``NotImplementedError`` naming it."""
    if name not in PARAM_DTYPES:
        raise NotImplementedError(f"param_dtype={name!r}: the port keeps parameters in {', '.join(PARAM_DTYPES)}")
    return PARAM_DTYPES[name]


def to_param_dtype(state_dict, dtype: torch.dtype) -> dict:
    """``state_dict`` with its parameters in ``dtype``; BatchNorm's running
    statistics (fp32 whatever the parameters are) and integer entries as
    they are."""
    return {k: v.to(dtype) if v.is_floating_point() and not k.endswith(("running_mean", "running_var")) else v
            for k, v in state_dict.items()}


class Conv3x3(nn.Module):
    """3³ SAME conv, stride 1, with bias, over NDHWC; ReLU fused if ``relu``.

    ``weight`` is (Co, Ci, 3, 3, 3) as in ``nn.Conv3d``. The kernel's packed
    weight is built the first time a forward needs it after a load or a
    move, and reused until the parameter changes again.
    """

    level = 0  # the U-Net level (set by UNet3D)
    tp: Optional[collectives.ChannelShard] = None  # set by sharding.shard_model

    def __init__(self, in_ch: int, out_ch: int, relu: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))
        self.relu = relu
        self._packed = None  # (key, packed weight)

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel's packed weight in the compute ``dtype``, from the
        parameter in its own dtype."""
        w = self.weight
        # an inference-mode tensor has no version counter (and cannot be
        # changed in place outside inference mode)
        key = (w.device, dtype, w.data_ptr(), None if w.is_inference() else w._version)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, pack_weight(w.detach(), dtype))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.packed_weight(x.dtype)
        train = torch.is_grad_enabled()

        def conv(t):
            if self.tp is not None:
                t = self.tp.input(t, self.weight.shape[1])
            if train:
                return conv3x3_train(t, self.weight, self.bias, packed)
            return conv3x3x3(t, packed, self.bias.detach(), self.relu)

        plan = collectives.spatial_plan()
        y = halo_conv(conv, x, plan.comm) if plan is not None and plan.sharded(self.level) else conv(x)
        return torch.relu(y) if train and self.relu else y


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm over NDHWC with the JAX package's arithmetic (``norm.py``),
    and with ``relu`` the ReLU after it.

    Eval: ``mult = gamma * rsqrt(var + eps)`` and ``shift = beta - mean *
    mult`` in fp32 from the running statistics, applied to the tensor in
    its own dtype (``norm.py:77-82``), then the ReLU. Training
    (``ops.kernels.batchnorm.batchnorm_train``: the CUDA kernels for a CUDA
    tensor, the plain version for a CPU tensor): the same with the batch's
    statistics, and the running statistics move by momentum 0.1 (flax 0.9)
    toward the batch mean and the unbiased batch variance, once per
    forward: not while a rematerialized block recomputes its forward in the
    backward (``update_running_stats`` is then False). State-dict keys are
    ``nn.BatchNorm3d``'s.
    """

    update_running_stats = True
    level = 0  # the U-Net level (set by UNet3D)
    tp: Optional[collectives.ChannelShard] = None  # set by sharding.shard_model
    # a list while a data-parallel step defers the running-statistics update
    # (layout (b), train/steps.py): each forward appends its (mean, unbiased
    # var) instead, and the step replays the global chain in microbatch order
    stat_log = None

    def __init__(self, num_features: int, relu: bool = False, **kwargs):
        super().__init__(num_features, **kwargs)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            deferred = self.stat_log is not None
            running = self if self.update_running_stats and not deferred else None
            y, mean, unbiased = batchnorm_train(x, self.weight, self.bias, self.eps, collectives.batch_synchronized(),
                                                self.level, self.relu, running)
            if self.update_running_stats and deferred:
                self.stat_log.append((mean, unbiased))
            return y
        mult = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * mult
        y = x * mult.to(x.dtype) + shift.to(x.dtype)
        return torch.relu(y) if self.relu else y

    @torch.no_grad()
    def momentum_update(self, mean: torch.Tensor, unbiased_var: torch.Tensor) -> None:
        """Move the running statistics by momentum 0.1 toward one batch's."""
        keep = 1.0 - self.momentum
        self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
        self.running_var.copy_(keep * self.running_var + self.momentum * unbiased_var)
        self.num_batches_tracked.add_(1)


def _group_view(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, ..., C) → (N, voxels, groups, C // groups), a view."""
    return t.reshape(t.shape[0], -1, groups, t.shape[-1] // groups)


class _GroupNormFn(torch.autograd.Function):
    """GroupNorm over NDHWC with flax's arithmetic (``normalization.py``
    ``_compute_stats`` / ``_normalize``): per sample and group, the mean and
    the fast variance E[x²] − mean² clipped at 0, in fp32 over (voxels,
    channels of the group); ``y = (x − mean)·(rsqrt(var + eps)·γ) + β`` in
    fp32, cast to x's dtype. The backward is the analytic one, in fp32,
    saving x in its own dtype and the (N, G) statistics only.

    With ``comm`` (this rank holds one D-slab of each sample) the sums
    behind every mean over a sample's voxels are summed over ``comm``'s
    slabs, ``count`` being the sample's whole voxel count times the
    group's channels."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, comm=None, count=None):
        xg = _group_view(x, groups).to(torch.promote_types(x.dtype, torch.float32))
        if comm is None:
            mean = xg.mean((1, 3))
            var = (xg.square().mean((1, 3)) - mean.square()).clamp_min(0.0)
        else:
            sums = comm.all_reduce(torch.stack([xg.sum((1, 3)), xg.square().sum((1, 3))])) / count
            mean, var = sums[0], (sums[1] - sums[0].square()).clamp_min(0.0)
        r = torch.rsqrt(var + eps)
        mult = r[:, None, :, None] * _group_view(weight.to(r.dtype)[None], groups)
        y = (xg - mean[:, None, :, None]) * mult + _group_view(bias.to(r.dtype)[None], groups)
        ctx.save_for_backward(x, weight, mean, r)
        ctx.groups, ctx.comm, ctx.count = groups, comm, count
        return y.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, r = ctx.saved_tensors
        g = ctx.groups
        r4 = r[:, None, :, None]
        xhat = (_group_view(x, g).to(r.dtype) - mean[:, None, :, None]) * r4
        dyg = _group_view(dy, g).to(r.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            dw = (dyg * xhat).sum((0, 1)).reshape(-1).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = dyg.sum((0, 1)).reshape(-1).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            dxhat = dyg * _group_view(weight.to(r.dtype)[None], g)
            if ctx.comm is None:
                m1, m2 = dxhat.mean((1, 3), keepdim=True), (dxhat * xhat).mean((1, 3), keepdim=True)
            else:
                sums = torch.stack([dxhat.sum((1, 3), keepdim=True), (dxhat * xhat).sum((1, 3), keepdim=True)])
                m1, m2 = ctx.comm.all_reduce(sums) / ctx.count
            dx = r4 * (dxhat - m1 - xhat * m2)
            dx = dx.reshape(x.shape).to(x.dtype)
        return dx, dw, db, None, None, None, None


class _GroupNormSpanFn(torch.autograd.Function):
    """GroupNorm of this rank's channel shard where its groups span the
    shards (``GroupNorm.shard_groups``): ``_GroupNormFn``'s arithmetic with
    each group's sums taken over its channels on every rank, per channel
    here, added into a (N, groups) table by each channel's group
    ``group_of`` and summed over ``comms`` (the model group, and the
    D-slabs' group on a spatially sharded level); ``count`` is a group's
    whole element count a sample."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group_of, groups, comms, count):
        xf = x.reshape(x.shape[0], -1, x.shape[-1]).to(torch.promote_types(x.dtype, torch.float32))
        sums = _group_sums(torch.stack([xf.sum(1), xf.square().sum(1)]), group_of, groups, comms) / count
        mean = sums[0]
        r = torch.rsqrt((sums[1] - mean.square()).clamp_min(0.0) + eps)
        mean, r = mean[:, group_of], r[:, group_of]  # (N, C) for the local channels
        y = (xf - mean[:, None]) * (r * weight.to(r.dtype))[:, None] + bias.to(r.dtype)
        ctx.save_for_backward(x, weight, mean, r, group_of)
        ctx.groups, ctx.comms, ctx.count = groups, comms, count
        return y.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, r, group_of = ctx.saved_tensors
        xhat = (x.reshape(x.shape[0], -1, x.shape[-1]).to(r.dtype) - mean[:, None]) * r[:, None]
        dyf = dy.reshape(xhat.shape).to(r.dtype)
        dw = (dyf * xhat).sum((0, 1)).to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = dyf.sum((0, 1)).to(weight.dtype) if ctx.needs_input_grad[2] else None
        dx = None
        if ctx.needs_input_grad[0]:
            dxhat = dyf * weight.to(r.dtype)
            sums = torch.stack([dxhat.sum(1), (dxhat * xhat).sum(1)])
            m1, m2 = _group_sums(sums, group_of, ctx.groups, ctx.comms)[:, :, group_of] / ctx.count
            dx = (r[:, None] * (dxhat - m1[:, None] - xhat * m2[:, None])).reshape(x.shape).to(x.dtype)
        return dx, dw, db, None, None, None, None, None


def _group_sums(per_channel: torch.Tensor, group_of: torch.Tensor, groups: int, comms) -> torch.Tensor:
    """(..., C) sums per local channel → (..., groups) sums per group over
    the channels of every rank of ``comms``."""
    table = per_channel.new_zeros((*per_channel.shape[:-1], groups)).index_add_(-1, group_of, per_channel)
    for comm in comms:
        comm.all_reduce(table)
    return table


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NDHWC with flax's arithmetic (``_GroupNormFn``), the
    same in training and eval: no running statistics. State-dict keys are
    ``nn.GroupNorm``'s (``weight``, ``bias``)."""

    level = 0  # the U-Net level (set by UNet3D)
    tp: Optional[collectives.ChannelShard] = None  # set by sharding.shard_model
    # where the groups span the channel shards: (the whole layer's groups,
    # each local channel's group index)
    _spanning: Optional[tuple] = None

    def shard_groups(self, local: int) -> None:
        """This rank holds ``local`` of the channels, from ``tp.span``'s
        start: whole groups of them where the shards keep groups whole (then
        ``num_groups`` counts the local groups), else each local channel's
        group is recorded and the statistics are summed over the model group."""
        start, per = self.tp.span[0], self.num_channels // self.num_groups
        if start % per == 0 and local % per == 0:
            self.num_groups = local // per
        else:
            group_of = torch.arange(start, start + local, device=self.weight.device) // per
            self._spanning = (self.num_groups, group_of)
        self.num_channels = local

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = collectives.spatial_plan()
        split = plan is not None and plan.sharded(self.level)
        if self._spanning is not None:
            groups, group_of = self._spanning
            voxels = x[0].numel() // x.shape[-1]  # a sample's, whole over the D-slabs
            if split:
                voxels = voxels // x.shape[1] * plan.depth(self.level)
            count = voxels * (self.tp.channels // groups)
            comms = ([plan.comm] if split else []) + [self.tp.comm]
            return _GroupNormSpanFn.apply(x, self.weight, self.bias, self.eps, group_of, groups, comms, count)
        if not split:
            return _GroupNormFn.apply(x, self.weight, self.bias, self.num_groups, self.eps)
        count = x[0].numel() // x.shape[1] * plan.depth(self.level) // self.num_groups
        return _GroupNormFn.apply(x, self.weight, self.bias, self.num_groups, self.eps, plan.comm, count)


@contextlib.contextmanager
def _frozen_running_stats(module: nn.Module):
    """BatchNorm layers of ``module`` leave their running statistics alone:
    the context of a rematerialized block's recomputation."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in norms:
            del m.update_running_stats


def _remat_contexts(module: nn.Module):
    return contextlib.nullcontext(), _frozen_running_stats(module)


class DoubleConv(nn.Module):
    """(3³ conv → norm → ReLU) × 2, as ``conv`` = Sequential of 6. The ReLU
    runs inside the BatchNorm (``relu``) or the conv (``norm_layer='none'``)
    where there is one, and its place holds an ``nn.Identity``: the
    indices, and so the state-dict keys, stay the reference's."""

    def __init__(self, in_ch: int, out_ch: int, norm_layer: str, groups: int = 8, device=None):
        super().__init__()
        fused = norm_layer == "none"
        layers = []
        for ci in (in_ch, out_ch):
            if fused:
                norm = nn.Identity()
            elif norm_layer == "group":
                norm = GroupNorm(min(groups, out_ch), out_ch, eps=1e-5, device=device)
            else:
                norm = BatchNorm(out_ch, relu=True, device=device)
            layers += [
                Conv3x3(ci, out_ch, relu=fused, device=device),
                norm,
                nn.ReLU() if norm_layer == "group" else nn.Identity(),
            ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MaxPool2x(nn.Module):
    """2³ stride-2 max-pool over NDHWC; odd trailing voxels are dropped.

    ``F.max_pool3d`` on the channels-last NCDHW view: its gradient goes to
    the first maximum of each window, as XLA's select-and-scatter does for
    ``nn.max_pool`` (ReLU outputs tie at 0 often)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class ConvTranspose2x(nn.Module):
    """2³ stride-2 transposed conv over NDHWC, as one matmul + pixel shuffle.

    ``weight`` is (Ci, Co, 2, 2, 2) as in ``nn.ConvTranspose3d``:
    ``out[n, 2d+a, 2h+b, 2w+c, o] = Σ_i x[n, d, h, w, i] · W[i, o, a, b, c]
    + bias[o]`` (``MatmulConvTranspose``, ``unet3d.py:258-298``, whose
    kernel is stored spatially flipped on the JAX side).
    """

    tp: Optional[collectives.ChannelShard] = None  # set by sharding.shard_model

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2, 2, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.input(x, self.weight.shape[0])
        n, d, h, w, ci = x.shape
        co = self.weight.shape[1]
        k = self.weight.to(x.dtype).permute(0, 2, 3, 4, 1).reshape(ci, 8 * co)
        y = (x.reshape(-1, ci) @ k).reshape(n, d, h, w, 2, 2, 2, co)
        y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * w, co)
        return y + self.bias.to(x.dtype)


def _pad_to_match(x: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad x's spatial dims to ``shape`` (D, H, W); the low side gets diff // 2."""
    pads = []
    for ax in (3, 2, 1):  # F.pad lists the last dim first
        diff = shape[ax - 1] - x.shape[ax]
        pads += [diff // 2, diff - diff // 2]
    if any(pads):
        x = F.pad(x, [0, 0] + pads)
    return x


class Down(nn.Module):
    """Max-pool from level ``level − 1``, DoubleConv at ``level``; on a
    spatially sharded rank the whole D is gathered first where ``level``
    runs replicated and ``level − 1`` sharded."""

    level = 1  # set by UNet3D

    def __init__(self, in_ch: int, out_ch: int, norm_layer: str, groups: int = 8, device=None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool2x(), DoubleConv(in_ch, out_ch, norm_layer, groups, device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = collectives.spatial_plan()
        if plan is not None and plan.sharded(self.level - 1) and not plan.sharded(self.level):
            x = collectives.gather_d(x, plan, self.level - 1)
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Transposed conv to ``out_ch``, pad-align, concat [skip, up], DoubleConv,
    at ``level``. On a spatially sharded rank whose ``level`` is sharded and
    the level below replicated, the upsampled whole volume is padded to the
    level's global shape and cut to this rank's slab."""

    level = 0  # set by UNet3D

    def __init__(self, in_ch: int, out_ch: int, norm_layer: str, groups: int = 8, device=None):
        super().__init__()
        self.up = ConvTranspose2x(in_ch, out_ch, device)
        self.conv = DoubleConv(2 * out_ch, out_ch, norm_layer, groups, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        plan = collectives.spatial_plan()
        if plan is not None and plan.sharded(self.level) and not plan.sharded(self.level + 1):
            start, stop = plan.slab(self.level)
            x = _pad_to_match(x, (plan.depth(self.level), *skip.shape[2:4]))[:, start:stop]
        else:
            x = _pad_to_match(x, skip.shape[1:4])
        tp = self.up.tp
        if tp is not None:  # the shards of each part joined before the concat
            skip, x = tp.whole(skip, tp.channels), tp.whole(x, tp.channels)
        return self.conv(torch.cat([skip.to(x.dtype), x], dim=-1))


class Conv1x1(nn.Module):
    """The 1×1×1 output conv; ``weight`` is (K, C, 1, 1, 1). Its logits are
    whole on every rank of a tensor-parallel model (gathered where its K
    outputs are sharded)."""

    tp: Optional[collectives.ChannelShard] = None  # set by sharding.shard_model

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1, 1, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.input(x, self.weight.shape[1])
        w = self.weight.reshape(self.weight.shape[:2]).to(x.dtype)
        y = F.linear(x, w, self.bias.to(x.dtype))
        return self.tp.whole(y, self.tp.channels) if self.tp is not None else y


class UNet3D(nn.Module):
    """4-level 3D U-Net: (N, D, H, W, n_modalities) → fp32 logits
    (N, D, H, W, n_classes). Base 64 with 5 modalities has 90,311,361
    parameters. ``norm_layer`` is 'batch', 'group' (GroupNorm with
    ``min(group_norm_groups, features)`` groups) or 'none' (BN folded).

    ``generator`` seeds the kaiming fan_out init (it must live on
    ``device``; drawn in fp32, then cast to ``param_dtype``); on the
    ``meta`` device nothing is initialised, which counts parameters without
    allocating them. ``remat`` recomputes each block in
    the backward instead of keeping its activations (training only).
    ``deep_supervision`` adds the aux heads: in training mode the forward
    then returns ``(logits, [aux_1/2, aux_1/4, aux_1/8])``, fine to coarse,
    each fp32; in eval mode the logits alone. ``from_config`` leaves them
    out unless asked, so the serving and validation models take a ``.pth``
    strictly whatever its config says.
    """

    def __init__(
        self,
        n_modalities: int = 5,
        n_classes: int = 1,
        base_features: int = 64,
        norm_layer: str = "batch",
        group_norm_groups: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
        deep_supervision: bool = False,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if norm_layer not in NORM_LAYERS:
            raise ValueError(f"norm_layer={norm_layer!r}; expected one of {NORM_LAYERS}")
        self.n_modalities = n_modalities
        self.n_classes = n_classes
        self.norm_layer = norm_layer
        self.dtype = dtype
        self.remat = remat
        self.deep_supervision = deep_supervision
        f, kw = base_features, dict(norm_layer=norm_layer, groups=group_norm_groups, device=device)
        self.inc = DoubleConv(n_modalities, f, **kw)
        self.down1 = Down(f, 2 * f, **kw)
        self.down2 = Down(2 * f, 4 * f, **kw)
        self.down3 = Down(4 * f, 8 * f, **kw)
        self.down4 = Down(8 * f, 16 * f, **kw)
        self.up1 = Up(16 * f, 8 * f, **kw)
        self.up2 = Up(8 * f, 4 * f, **kw)
        self.up3 = Up(4 * f, 2 * f, **kw)
        self.up4 = Up(2 * f, f, **kw)
        self.outc = Conv1x1(f, n_classes, device)
        if deep_supervision:  # after outc: the other parameters draw the init of a model without them
            self.ds1 = Conv1x1(8 * f, n_classes, device)
            self.ds2 = Conv1x1(4 * f, n_classes, device)
            self.ds3 = Conv1x1(2 * f, n_classes, device)
        for level, blocks in enumerate(((self.inc, self.up4), (self.down1, self.up3), (self.down2, self.up2),
                                        (self.down3, self.up1), (self.down4,))):
            for block in blocks:
                for m in block.modules():
                    if isinstance(m, (Conv3x3, BatchNorm, GroupNorm, Down, Up)):
                        m.level = level
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)
        if param_dtype != torch.float32:
            with torch.no_grad():
                for p in self.parameters():  # the buffers (running statistics) stay fp32
                    p.data = p.data.to(param_dtype)

    @classmethod
    def from_config(cls, config, norm_layer: Optional[str] = None, **kwargs) -> "UNet3D":
        """The model a config describes, with its parameters in
        ``config.param_dtype`` (JAX's ``unet3d.py:529``) and computing in
        ``config.compute_dtype``; a dtype the port does not take raises
        ``NotImplementedError`` naming it (``compute_dtype``,
        ``param_dtype``)."""
        return cls(
            n_modalities=config.n_modalities,
            n_classes=config.n_classes,
            base_features=config.base_features,
            norm_layer=norm_layer or config.norm_layer,
            group_norm_groups=config.group_norm_groups,
            dtype=compute_dtype(config.compute_dtype),
            param_dtype=param_dtype(config.param_dtype),
            remat=config.remat,
            **kwargs,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-normal fan_out (ReLU gain) weights, zero biases, norm γ=1 β=0."""
        for m in self.modules():
            if isinstance(m, (Conv3x3, Conv1x1)):
                fan_out = m.weight.shape[0] * math.prod(m.weight.shape[2:])
            elif isinstance(m, ConvTranspose2x):
                fan_out = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            elif isinstance(m, (BatchNorm, GroupNorm)):
                m.reset_parameters()
                continue
            else:
                continue
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.n_modalities:
            raise ValueError(
                f"expected {self.n_modalities} input channels (NDHWC), "
                f"got shape {tuple(x.shape)}"
            )
        plan = collectives.spatial_plan()
        dims = tuple(x.shape[1:4])
        if plan is not None:
            start, stop = plan.slab(0)
            if x.shape[1] != stop - start:
                raise ValueError(f"D-slab of {x.shape[1]} voxels where the plan holds [{start}, {stop})")
            dims = (plan.depth(0), *dims[1:])
        if any(s < MIN_INPUT_SIZE for s in dims):
            raise ValueError(
                f"spatial dims {dims} too small: the 4-level "
                f"U-Net needs every spatial dim >= {MIN_INPUT_SIZE}"
            )
        x = x.to(self.dtype)
        x1 = self._block(self.inc, x)
        x2 = self._block(self.down1, x1)
        x3 = self._block(self.down2, x2)
        x4 = self._block(self.down3, x3)
        x5 = self._block(self.down4, x4)
        ds, aux = self.deep_supervision and self.training, []
        x = self._block(self.up1, x5, x4)
        if ds:
            aux.append(self.ds1(x).float())  # 1/8 resolution
        x = self._block(self.up2, x, x3)
        if ds:
            aux.append(self.ds2(x).float())  # 1/4
        x = self._block(self.up3, x, x2)
        if ds:
            aux.append(self.ds3(x).float())  # 1/2
        x = self._block(self.up4, x, x1)
        logits = self.outc(x).float()
        if ds:
            return logits, aux[::-1]  # fine to coarse, the order of train/steps.py's DS_WEIGHTS
        return logits

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """Run one block; with ``remat`` in training, keep only its inputs and
        recompute it in the backward (block-level, ``unet3d.py:446-455``)."""
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(
                block, *args, use_reentrant=False,
                context_fn=functools.partial(_remat_contexts, block),
            )
        return block(*args)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Sigmoid probabilities, or softmax over channels for K >= 2."""
        logits = self(x)
        if self.n_classes >= 2:
            return torch.softmax(logits, dim=-1)
        return torch.sigmoid(logits)

    def inference(self, x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
        """Binary mask at ``threshold``, or the argmax label map for K >= 2
        (float, keeping the trailing channel dim)."""
        probs = self.predict(x)
        if self.n_classes >= 2:
            return probs.argmax(dim=-1, keepdim=True).float()
        return (probs > threshold).float()


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
