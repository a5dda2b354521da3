"""The plain reference of nnU-Net's 3d_fullres training: the PlainConvUNet
forward, the deep-supervised CE + Dice loss, its gradients and Nesterov SGD,
in float32 with stock PyTorch operations (channels first, ``F.conv3d``,
``F.instance_norm``, ``F.leaky_relu``, ``F.conv_transpose3d``; TF32 off
inside ``no_tf32``).

It imports nothing of the program under test. Parameters are a state dict in
the layout of nnU-Net's ``PlainConvUNet`` without the second names of its
tensors (``encoder.stages.{s}.0.convs.{j}.{conv,norm}``,
``decoder.transpconvs.{s}``, ``decoder.stages.{s}.convs.{j}.{conv,norm}``,
``decoder.seg_layers.{s}``), the same dict the program loads.

The source: nnU-Net v2 (Isensee et al., Nature Methods 18:203-211, 2021),
its default ``ExperimentPlanner`` for 3d_fullres, ``dynamic_network_architectures``
``PlainConvUNet`` and ``nnUNetTrainer``: 3³ convs with bias, stride 2 at the
first conv of every stage but the first, InstanceNorm (eps 1e-5, affine),
LeakyReLU(0.01), 2³ stride-2 transposed convs with bias, ``cat([up, skip])``,
a 1×1×1 head a decoder stage; loss CE + soft Dice over the foreground
classes (batch Dice, smooth 1e-5), weighted 1 : 1 at every head by 1/2^i
normalised with the lowest head's weight 0; gradients clipped at norm 12
(``clip_grad_norm_``); SGD, momentum 0.99, Nesterov, coupled weight decay
3e-5; He-normal init (a = 1e-2), zero biases.

Departures from nnU-Net:
  * nnU-Net trains in fp16 autocast with a GradScaler; this reference
    computes in float32 (the program in bf16, without loss scaling).
  * The Dice term is ``1 − Dice`` where nnU-Net's is ``−Dice``: the same
    gradient, the loss 1 higher.
  * The lowest-resolution head is not computed: its weight is 0, so nnU-Net
    skips its loss term and its parameters get no gradient either way.
    The weights are those of nnU-Net's 6-stage plan by scale (8/15, 4/15,
    2/15, 1/15 at full, 1/2, 1/4, 1/8); a plan of fewer stages keeps those
    of the scales it has above its lowest head, unnormalised, where nnU-Net
    would normalise them again.
  * A head's labels are the nearest voxels at half-pixel centres (voxel
    ``f·i + f/2`` of a head ``f`` times coarser), where nnU-Net resizes
    them with order 0.
  * No augmentation, no dropout (nnU-Net's default has none).

``Precision`` runs the network in float32, or for the control in int8 (or
fp8), a precision below the program's bf16: every conv, transposed conv and
head on rounded operands and incoming gradients with float32 sums, and
every activation and the norms' scale and shift rounded, each with a
per-tensor scale.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NORM_EPS = 1e-5
NEG_SLOPE = 1e-2
# nnU-Net's deep-supervision weights at 6 stages (5 heads), full resolution
# first: 1/2^i with the last set to 0, normalised
DS_WEIGHTS = tuple(w / sum([1.0, 0.5, 0.25, 0.125]) for w in (1.0, 0.5, 0.25, 0.125, 0.0))


def _fp8(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` rounded to ``dtype`` (fp8) with a per-tensor scale, back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(torch.float32) * scale


def _int8(t: Tensor) -> Tensor:
    """``t`` rounded to int8 with a per-tensor symmetric scale, back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


# per kind: (forward operands and activations, the backward's incoming gradient)
ROUNDING = {"fp8": (lambda t: _fp8(t, torch.float8_e4m3fn), lambda t: _fp8(t, torch.float8_e5m2)),
            "int8": (_int8, _int8)}


class _LowOp(torch.autograd.Function):
    """``op(x, w, b)`` on low-precision operands: x and w rounded for the
    forward; the incoming gradient rounded for both products of the
    backward, which take the rounded operands too."""

    @staticmethod
    def forward(ctx, x, w, b, op, kind):
        fwd, _ = ROUNDING[kind]
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq, b)
        ctx.op, ctx.kind = op, kind
        return op(xq, wq, b)

    @staticmethod
    def backward(ctx, dy):
        xq, wq, b = ctx.saved_tensors
        with torch.enable_grad():
            xq, wq, b = (t.detach().requires_grad_(True) for t in (xq, wq, b))
            y = ctx.op(xq, wq, b)
            dx, dw, db = torch.autograd.grad(y, (xq, wq, b), ROUNDING[ctx.kind][1](dy))
        return dx, dw, db, None, None


class Precision:
    """float32 (``None``) or, for the control, 'fp8' or 'int8': the matrix
    products as ``_LowOp`` runs them, and every activation and the norms'
    scale and shift rounded with a per-tensor scale (the gradient passed
    straight through)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, *ROUNDING):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, op, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        return op(x, w, b) if self.kind is None else self.act(_LowOp.apply(x, w, b, op, self.kind))

    def act(self, t: Tensor) -> Tensor:
        if self.kind is None:
            return t
        return t + (ROUNDING[self.kind][0](t.detach()) - t.detach())


FP32 = Precision()


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- the state dict -----------------------------------------------------------------


def state_shapes(n_modalities: int, n_classes: int, features: Sequence[int],
                 convs: int = 2) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the state dict, in the model's order, with its shape."""
    out: Dict[str, Tuple[int, ...]] = {}

    def block(key, ci, co):
        for j in range(convs):
            out[f"{key}.convs.{j}.conv.weight"] = (co, ci if j == 0 else co, 3, 3, 3)
            out[f"{key}.convs.{j}.conv.bias"] = (co,)
            out[f"{key}.convs.{j}.norm.weight"] = (co,)
            out[f"{key}.convs.{j}.norm.bias"] = (co,)

    for s, co in enumerate(features):
        block(f"encoder.stages.{s}.0", n_modalities if s == 0 else features[s - 1], co)
    n = len(features) - 1
    for s in range(n):
        below, skip = features[n - s], features[n - s - 1]
        out[f"decoder.transpconvs.{s}.weight"] = (below, skip, 2, 2, 2)
        out[f"decoder.transpconvs.{s}.bias"] = (skip,)
    for s in range(n):
        block(f"decoder.stages.{s}", 2 * features[n - s - 1], features[n - s - 1])
    for s in range(n):
        out[f"decoder.seg_layers.{s}.weight"] = (n_classes, features[n - s - 1], 1, 1, 1)
        out[f"decoder.seg_layers.{s}.bias"] = (n_classes,)
    return out


def init_state(config: dict, seed: int, device) -> Dict[str, Tensor]:
    """A state dict for ``config`` (``n_modalities``, ``n_classes``,
    ``nnunet_features``) from ``seed``: He-normal weights (a = 1e-2, fan in:
    a conv's Ci·k³, a transposed conv's Co·8, nn.init's reading of its
    (Ci, Co, k, k, k) weight) from one draw of a generator on ``device``,
    zero biases, norm scale 1 and shift 0."""
    shapes = state_shapes(config["n_modalities"], config["n_classes"], config["nnunet_features"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    weights = [k for k, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in weights), generator=gen, device=device)
    gain = math.sqrt(2.0 / (1.0 + NEG_SLOPE ** 2))
    out, at = {}, 0
    for key, shape in shapes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            fan_in = shape[1] * math.prod(shape[2:])
            out[key] = flat[at: at + n].view(shape).mul_(gain / math.sqrt(fan_in))
            at += n
        elif key.endswith("norm.weight"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


# ---- the network --------------------------------------------------------------------


def _conv(x, w, b):
    return F.conv3d(x, w, b, padding=w.shape[-1] // 2)


def _conv_s2(x, w, b):
    return F.conv3d(x, w, b, stride=2, padding=1)


def _up(x, w, b):
    return F.conv_transpose3d(x, w, b, stride=2)


def _norm(x: Tensor, sd: Dict[str, Tensor], key: str, groups: Optional[int], prec: Precision) -> Tensor:
    """InstanceNorm (``groups`` None), or GroupNorm of ``groups`` groups (all
    channels where fewer)."""
    w, b = prec.act(sd[f"{key}.weight"]), prec.act(sd[f"{key}.bias"])
    if groups is None:
        y = F.instance_norm(x, eps=NORM_EPS)
    else:
        y = F.group_norm(x, min(groups, x.shape[1]), eps=NORM_EPS)
    view = (1, -1, 1, 1, 1)
    return prec.act(prec.act(y) * w.view(view) + b.view(view))


def _stage(x, sd, key, first_stride, prec, slope, groups, convs=2):
    for j in range(convs):
        op = _conv_s2 if j == 0 and first_stride == 2 else _conv
        x = prec(op, x, sd[f"{key}.convs.{j}.conv.weight"], sd[f"{key}.convs.{j}.conv.bias"])
        x = prec.act(F.leaky_relu(_norm(x, sd, f"{key}.convs.{j}.norm", groups, prec), slope))
    return x


def n_stages(sd: Dict[str, Tensor]) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith("encoder.stages.")})


def forward(sd: Dict[str, Tensor], x: Tensor, deep_supervision: bool = False, prec: Precision = FP32,
            slope: float = NEG_SLOPE, groups: Optional[int] = None):
    """Logits (N, K, D, H, W) of images (N, C, D, H, W); with
    ``deep_supervision`` (logits, [the heads at 1/2, 1/4, 1/8]) of the heads
    above the lowest decoder stage's."""
    stages = n_stages(sd)
    skips = []
    for s in range(stages):
        x = _stage(x, sd, f"encoder.stages.{s}.0", 1 if s == 0 else 2, prec, slope, groups)
        skips.append(x)
    heads = []
    n = stages - 1
    for s in range(n):
        x = prec(_up, x, sd[f"decoder.transpconvs.{s}.weight"], sd[f"decoder.transpconvs.{s}.bias"])
        x = torch.cat([x, skips[n - s - 1]], 1)
        x = _stage(x, sd, f"decoder.stages.{s}", 1, prec, slope, groups)
        scale = 2 ** (n - 1 - s)
        if deep_supervision and s >= 1 and scale in (2, 4, 8) or s == n - 1:
            heads.append(prec(F.conv3d, x, sd[f"decoder.seg_layers.{s}.weight"], sd[f"decoder.seg_layers.{s}.bias"]))
    if not deep_supervision:
        return heads[-1]
    return heads[-1], heads[-2::-1]


# ---- the loss -----------------------------------------------------------------------


def dc_and_ce(logits: Tensor, labels: Tensor, smooth: float = 1e-5) -> Tensor:
    """Cross-entropy (mean over voxels) + 1 − soft Dice of the foreground
    classes, each class's sums over the batch and the volume (batch Dice),
    weighted 1 : 1; ``labels`` (N, D, H, W) class ids."""
    k = logits.shape[1]
    ce = F.cross_entropy(logits, labels.long())
    p = torch.softmax(logits, 1)
    t = F.one_hot(labels.long(), k).permute(0, 4, 1, 2, 3).float()
    dims = (0, 2, 3, 4)
    dice = (2.0 * (p * t).sum(dims) + smooth) / (p.sum(dims) + t.sum(dims) + smooth)
    return ce + (1.0 - dice[1:].mean())


def head_labels(labels: Tensor, factor: int) -> Tensor:
    """Labels (N, D, H, W) at a head ``factor`` times coarser: the voxels at
    the half-pixel centres ``factor·i + factor // 2``."""
    o = factor // 2
    return labels[:, o::factor, o::factor, o::factor]


def deep_supervision_loss(out, labels: Tensor, smooth: float = 1e-5) -> Tensor:
    logits, aux = out
    total = DS_WEIGHTS[0] * dc_and_ce(logits, labels, smooth)
    for i, a in enumerate(aux, start=1):
        total = total + DS_WEIGHTS[i] * dc_and_ce(a, head_labels(labels, 2 ** i), smooth)
    return total


# ---- the train step -----------------------------------------------------------------


class NesterovSGD:
    """``torch.nn.utils.clip_grad_norm_`` (the gradients times
    min(1, max_norm / (‖g‖ + 1e-6))), then SGD with coupled weight decay,
    momentum and Nesterov, as ``torch.optim.SGD`` computes them."""

    def __init__(self, params: Dict[str, Tensor], lr, momentum, weight_decay, clip):
        self.params, self.lr, self.momentum, self.wd, self.clip = params, lr, momentum, weight_decay, clip
        self.buf: Dict[str, Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> Tensor:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        coef = torch.clamp(self.clip / (norm + 1e-6), max=1.0) if self.clip > 0 else torch.ones_like(norm)
        for k, p in self.params.items():
            g = grads[k] * coef + self.wd * p
            if k not in self.buf:
                self.buf[k] = g.clone()
            else:
                self.buf[k].mul_(self.momentum).add_(g)
            p.sub_(self.lr * (g + self.momentum * self.buf[k]))
        return norm


def trained(key: str, stages: int, deep_supervision: bool = True) -> bool:
    """Whether a loss reads ``key``'s parameter: every one but the heads no
    loss weighs (the lowest-resolution head always)."""
    if not key.startswith("decoder.seg_layers."):
        return True
    s, n = int(key.split(".")[2]), stages - 1
    return s == n - 1 or deep_supervision and s >= 1 and 2 ** (n - 1 - s) in (2, 4, 8)


def train_steps(state: Dict[str, Tensor], batches: List[tuple], cfg: dict, prec: Precision = FP32,
                slope: float = NEG_SLOPE, groups: Optional[int] = None):
    """``cfg``'s train step over ``batches`` [(images (B, D, H, W, C),
    labels (B, D, H, W, 1)), ...] from ``state`` (changed in place): the
    batch as one microbatch, the deep-supervised loss, the clip and SGD.
    Returns (the step losses, the gradient as SGD took it at step 1 (its
    momentum buffer, g + wd·p), per leaf)."""
    stages = n_stages(state)
    ds = cfg.get("deep_supervision", True)
    params = {k: v.requires_grad_(True) for k, v in state.items() if trained(k, stages, ds)}
    opt = NesterovSGD(params, cfg["learning_rate"], cfg["momentum"], cfg["weight_decay"], cfg["grad_clip_norm"])
    smooth = cfg.get("dice_smooth", 1e-5)
    losses, first = [], None
    for images, labels in batches:
        x = images.float().permute(0, 4, 1, 2, 3).contiguous()
        y = labels[..., 0]
        out = forward(state, x, ds, prec, slope, groups)
        loss = deep_supervision_loss(out, y, smooth) if ds else dc_and_ce(out, y, smooth)
        g = torch.autograd.grad(loss, list(params.values()))
        opt.step(dict(zip(params, g)))
        if first is None:
            first = {k: b.clone() for k, b in opt.buf.items()}
        losses.append(float(loss.detach()))
        del out, loss, g
    for p in params.values():
        p.requires_grad_(False)
    return losses, first
