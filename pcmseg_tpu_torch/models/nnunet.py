"""nnU-Net's ``3d_fullres`` network in PyTorch, NDHWC, for training and serving.

``PlainConvUNet`` as nnU-Net v2 builds it (``dynamic_network_architectures``
``PlainConvUNet``, planned by the default ``ExperimentPlanner``; Isensee et
al., Nature Methods 18:203-211, 2021): for an isotropic 128³ volume 6 stages
of features (32, 64, 128, 256, 320, 320), 3³ kernels, strides (1, 2, 2, 2, 2,
2), two convs a stage in the encoder and in the decoder, every conv with its
bias, then InstanceNorm (eps 1e-5, affine) and LeakyReLU(0.01).

  * Encoder stage s: the first conv has stride 1 at s = 0 (``Conv3x3``, the
    port's B1 kernel forward and dx, B2 for dW) and stride 2 after
    (``StridedConv3x3``: cuDNN through ``F.conv3d(stride=2)`` on the
    channels-last view, with its own autograd Function); the second conv is
    a ``Conv3x3``.
  * Decoder stage s: a 2³ stride-2 transposed conv with bias
    (``ConvTranspose2x``), pad-align, ``cat([up, skip])``, two
    ``Conv3x3`` + norm + LeakyReLU, and a 1×1×1 segmentation head
    (``Conv1x1``).
  * InstanceNorm is PyTorch's fused ``group_norm`` with one group a
    channel: statistics per sample and channel, the same in training and
    eval, no running statistics; its scale and shift in the compute dtype.

Deep supervision (``deep_supervision``, training only): the forward returns
``(logits, [aux_1/2, aux_1/4, aux_1/8])``, fine to coarse, as ``UNet3D``
does, so the train step's ``DS_WEIGHTS`` (8/15, 4/15, 2/15, 1/15) apply: at 6
stages they are nnU-Net's own weights, whose lowest-resolution head (1/16)
weighs 0. That head, and any other head no loss reads, is left uncomputed
and frozen (``requires_grad`` False), which is what nnU-Net's zero weight
gives: its loss term is skipped, so its parameters get no gradient and SGD
leaves them. With fewer stages the heads above the lowest take the first
weights, unnormalised. Every head is a parameter, so the state dict is the
same with and without deep supervision.

Module names follow ``PlainConvUNet``'s:

  ``encoder.stages.{s}.0.convs.{j}.{conv,norm}``,
  ``decoder.transpconvs.{s}``, ``decoder.stages.{s}.convs.{j}.{conv,norm}``,
  ``decoder.seg_layers.{s}`` (decoder stage 0 is the lowest resolution).

An nnU-Net checkpoint's ``network_weights`` also holds each conv block's
``all_modules.{i}`` and the decoder's ``decoder.encoder.*``, second names of
the same tensors: dropping those keys leaves this model's state dict. Its
weights are channels-first ``nn.Conv3d`` / ``nn.ConvTranspose3d`` layouts,
as here.

Init (``InitWeights_He(1e-2)``): He-normal, ``kaiming_normal_(a=1e-2)``
(fan in: a conv's Ci·27, a transposed conv's Co·8, a head's C), zero biases,
norm scale 1 and shift 0, from ``generator``.

Parameters in ``param_dtype``, activations in ``dtype``, logits fp32, as in
``UNet3D``. With ``remat`` each stage is recomputed in the backward. One
rank: a spatial or tensor-parallel plan raises ``NotImplementedError``.

Each stage runs under a program span, ``nnunet.encoder`` and
``nnunet.decoder`` keyed by its index, so a trace splits the forward's device
time by stage. ``strided_launches`` and ``instance_norm_calls`` count the
strided convs' and the norms' forwards on CUDA tensors (CPU calls not
counted), as ``conv3d.launches`` counts B1's.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcmseg_tpu_torch.models.unet3d import Conv1x1, Conv3x3, ConvTranspose2x, _pad_to_match, compute_dtype, param_dtype
from pcmseg_tpu_torch.parallel import collectives
from pcmseg_tpu_torch.utils.profiling import span

# nnU-Net's 3d_fullres plan for a 128³ isotropic volume: 32 features, doubled
# a stage and capped at 320, halved until the feature map's edge is 4
FEATURES_3D_FULLRES = (32, 64, 128, 256, 320, 320)
NEG_SLOPE = 1e-2  # LeakyReLU's, and the He init's a
NORM_EPS = 1e-5
# the resolutions of the deep-supervision heads the train step weighs,
# fine to coarse, as powers of 1/2 (train/steps.py DS_WEIGHTS after the full one)
AUX_SCALES = (1, 2, 3)

# forwards since the count was last set to 0, on CUDA tensors
strided_launches = 0
instance_norm_calls = 0
_count_lock = threading.Lock()


def _count(name: str, x: torch.Tensor) -> None:
    if x.is_cuda:
        with _count_lock:
            globals()[name] += 1


class _NoTF32:
    """fp32 convolutions in fp32 on the card inside the block (cuDNN would
    take TF32 otherwise): the port's fp32 compute is fp32's accuracy."""

    def __init__(self, dtype: torch.dtype):
        self.on = dtype == torch.float32

    def __enter__(self):
        if self.on:
            self.saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        if self.on:
            torch.backends.cudnn.allow_tf32 = self.saved


class _StridedConvFn(torch.autograd.Function):
    """3³ conv, stride 2, padding 1, over NDHWC: ``F.conv3d`` on the
    channels-last NCDHW view (cuDNN on the card), its dx and dW by
    ``aten.convolution_backward``, db as the fp32 sum of dy."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.param_dtype = weight.dtype
        with _NoTF32(x.dtype):
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias.to(x.dtype), stride=2, padding=1)
        return y.permute(0, 2, 3, 4, 1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dyc = dy.permute(0, 4, 1, 2, 3)
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _NoTF32(x.dtype):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dyc, x.permute(0, 4, 1, 2, 3), w, None, [2, 2, 2], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, mask)
        if dx is not None:
            dx = dx.permute(0, 2, 3, 4, 1).contiguous()
        if dw is not None:
            dw = dw.to(ctx.param_dtype)
        db = None
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2, 3), dtype=torch.promote_types(dy.dtype, torch.float32)).to(ctx.param_dtype)
        return dx, dw, db


class StridedConv3x3(nn.Module):
    """3³ conv with stride 2, padding 1 and bias over NDHWC: (N, D, H, W, Ci)
    → (N, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉, Co). ``weight`` is (Co, Ci, 3, 3, 3) as in
    ``nn.Conv3d``."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _count("strided_launches", x)
        return _StridedConvFn.apply(x, self.weight, self.bias)


class InstanceNorm(nn.InstanceNorm3d):
    """``nn.InstanceNorm3d(affine=True)`` over NDHWC, the same in training and
    eval: PyTorch's fused ``group_norm`` with one group a channel on an
    NCDHW copy (statistics per sample and channel in fp32, the scale and
    shift applied inside the kernel, one rounding to x's dtype; the CUDA
    kernel reads its input NCDHW-contiguous, and the CPU's channels-last
    kernel sums E[x²] − mean², which loses digits), written back
    NDHWC-contiguous. The scale and shift enter in x's dtype, as the convs'
    weights do. State-dict keys ``weight``, ``bias``."""

    def __init__(self, channels: int, eps: float = NORM_EPS, device=None):
        super().__init__(channels, eps=eps, affine=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _count("instance_norm_calls", x)
        # torch.group_norm is F.group_norm without its refusal of a one-voxel
        # stage (the deepest at 32³, evaluated a sample at a time): it gives β
        y = torch.group_norm(x.permute(0, 4, 1, 2, 3).contiguous(), self.num_features, self.weight.to(x.dtype),
                             self.bias.to(x.dtype), self.eps, torch.backends.cudnn.enabled)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class ConvNormAct(nn.Module):
    """``ConvDropoutNormReLU`` without dropout: conv → InstanceNorm →
    LeakyReLU(0.01); the conv strided where ``stride`` is 2."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.conv = StridedConv3x3(in_ch, out_ch, device) if stride == 2 else Conv3x3(in_ch, out_ch, False, device)
        self.norm = InstanceNorm(out_ch, device=device)
        self.nonlin = nn.LeakyReLU(NEG_SLOPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlin(self.norm(self.conv(x)))


class StackedConvBlocks(nn.Module):
    """``n`` ``ConvNormAct`` in ``convs``, the first with ``stride``."""

    def __init__(self, n: int, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.convs = nn.Sequential(*[ConvNormAct(in_ch if j == 0 else out_ch, out_ch, stride if j == 0 else 1, device)
                                     for j in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class Encoder(nn.Module):
    def __init__(self, n_modalities: int, features: Sequence[int], convs_per_stage: int, device=None):
        super().__init__()
        ins = [n_modalities, *features[:-1]]
        self.stages = nn.Sequential(*[
            nn.Sequential(StackedConvBlocks(convs_per_stage, ci, co, 1 if s == 0 else 2, device))
            for s, (ci, co) in enumerate(zip(ins, features))
        ])


class Decoder(nn.Module):
    def __init__(self, features: Sequence[int], n_classes: int, convs_per_stage: int, device=None):
        super().__init__()
        below, skips = features[:0:-1], features[-2::-1]  # stage s: from features[-s-1] up to features[-s-2]
        self.transpconvs = nn.ModuleList([ConvTranspose2x(b, k, device) for b, k in zip(below, skips)])
        self.stages = nn.ModuleList([StackedConvBlocks(convs_per_stage, 2 * k, k, 1, device) for k in skips])
        self.seg_layers = nn.ModuleList([Conv1x1(k, n_classes, device) for k in skips])


class PlainConvUNet(nn.Module):
    """nnU-Net's PlainConvUNet: (N, D, H, W, n_modalities) → fp32 logits
    (N, D, H, W, n_classes); every spatial dim a multiple of 2^(stages − 1).
    At the 3d_fullres plan with 5 modalities and 3 classes it has
    31,199,855 parameters (module docstring).

    ``generator`` seeds the He init (it must live on ``device``; drawn in
    fp32, then cast to ``param_dtype``); on the ``meta`` device nothing is
    initialised."""

    def __init__(
        self,
        n_modalities: int = 5,
        n_classes: int = 3,
        features: Sequence[int] = FEATURES_3D_FULLRES,
        convs_per_stage: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
        deep_supervision: bool = False,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if len(features) < 2:
            raise ValueError(f"features={tuple(features)}: a PlainConvUNet has at least 2 stages")
        self.n_modalities = n_modalities
        self.n_classes = n_classes
        self.features = tuple(features)
        self.dtype = dtype
        self.remat = remat
        self.deep_supervision = deep_supervision
        self.encoder = Encoder(n_modalities, features, convs_per_stage, device)
        self.decoder = Decoder(features, n_classes, convs_per_stage, device)
        n = len(self.decoder.stages)
        # decoder stages whose heads the train step weighs, coarse to fine:
        # 1/2, 1/4, 1/8 of the full resolution, never the lowest stage's
        self.aux_stages = [n - 1 - k for k in AUX_SCALES[::-1] if 1 <= n - 1 - k] if deep_supervision else []
        for s, head in enumerate(self.decoder.seg_layers):
            head.requires_grad_(s == n - 1 or s in self.aux_stages)
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)
        if param_dtype != torch.float32:
            with torch.no_grad():
                for p in self.parameters():
                    p.data = p.data.to(param_dtype)

    @classmethod
    def from_config(cls, config, **kwargs) -> "PlainConvUNet":
        """The model a config describes (``nnunet_features``, ``n_modalities``,
        ``n_classes``, the dtypes, ``remat``). A spatial or tensor-parallel
        mesh raises ``NotImplementedError``."""
        if config.spatial_parallel > 1 or config.tensor_parallel > 1:
            raise NotImplementedError(
                f"nnU-Net's PlainConvUNet runs on one rank a sample: spatial_parallel={config.spatial_parallel}, "
                f"tensor_parallel={config.tensor_parallel}")
        return cls(
            n_modalities=config.n_modalities,
            n_classes=config.n_classes,
            features=config.nnunet_features,
            dtype=compute_dtype(config.compute_dtype),
            param_dtype=param_dtype(config.param_dtype),
            remat=config.remat,
            **kwargs,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """He-normal weights (``kaiming_normal_(a=1e-2)``, fan in), zero biases,
        norm scale 1 and shift 0."""
        gain = math.sqrt(2.0 / (1.0 + NEG_SLOPE ** 2))
        for m in self.modules():
            if isinstance(m, InstanceNorm):
                m.reset_parameters()
            elif isinstance(m, (Conv3x3, StridedConv3x3, Conv1x1, ConvTranspose2x)):
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                m.weight.normal_(0.0, gain / math.sqrt(fan_in), generator=generator)
                m.bias.zero_()

    def _stage(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def forward(self, x: torch.Tensor):
        if x.shape[-1] != self.n_modalities:
            raise ValueError(f"expected {self.n_modalities} input channels (NDHWC), got shape {tuple(x.shape)}")
        if collectives.spatial_plan() is not None:
            raise NotImplementedError("nnU-Net's PlainConvUNet runs on one rank a sample, under no spatial plan")
        step = 2 ** (len(self.features) - 1)
        if any(s % step for s in x.shape[1:4]):
            raise ValueError(f"spatial dims {tuple(x.shape[1:4])}: a {len(self.features)}-stage PlainConvUNet "
                             f"needs each a multiple of {step}")
        x = x.to(self.dtype)
        skips: List[torch.Tensor] = []
        for s, stage in enumerate(self.encoder.stages):
            with span("nnunet.encoder", s):
                x = self._stage(stage, x)
            skips.append(x)
        dec, aux = self.decoder, []
        ds = self.deep_supervision and self.training
        for s, (up, stage) in enumerate(zip(dec.transpconvs, dec.stages)):
            with span("nnunet.decoder", s):
                skip = skips[-(s + 2)]
                x = torch.cat([_pad_to_match(up(x), skip.shape[1:4]), skip], dim=-1)
                x = self._stage(stage, x)
                if ds and s in self.aux_stages:
                    aux.append(dec.seg_layers[s](x).float())
        logits = dec.seg_layers[-1](x).float()
        if ds:
            return logits, aux[::-1]  # fine to coarse, the order of train/steps.py's DS_WEIGHTS
        return logits

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Softmax probabilities over the classes (sigmoid for one class)."""
        logits = self(x)
        return torch.softmax(logits, dim=-1) if self.n_classes >= 2 else torch.sigmoid(logits)
