"""The plain reference of both configurations: the 4-level 3-D U-Net of
qwertyhgb/Prostate-Cancer-Multimodal-Segmentation (``models/unet3d.py``),
its losses, the optimizer chain and the serving ensemble, in float32 with
stock PyTorch operations (channels first, ``F.conv3d``; TF32 off).

It imports nothing of the program under test. Parameters are a state dict
in the reference model's layout (``inc.conv.{0,1,3,4}``,
``down{i}.maxpool_conv.1.conv.*``, ``up{i}.up``, ``up{i}.conv.conv.*``,
``outc``), the same dict the benchmark hands the program.

``Precision`` runs the network in float32, or for the control in int8 (or
fp8), a precision below the configurations' bf16: every conv, transposed
conv and 1×1 head on rounded operands and incoming gradients (fp8: e4m3
and e5m2) with float32 sums, and every activation and the norms' scale and
shift rounded, each with a per-tensor scale."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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
    """``op(x, w, b)`` on low-precision operands as low-precision training
    runs it: x and w rounded for the forward; the incoming gradient rounded
    for both products of the backward, which take the rounded operands too."""

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
    """Where the program computes in its compute dtype, the reference
    computes in float32 (``None``) or, for the control, in 'fp8' or 'int8':
    the matrix products as :class:`_LowOp` runs them, and every activation
    they and the norms make, and the norms' per-channel scale and shift,
    rounded with a per-tensor scale (the gradient passed straight through)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, *ROUNDING):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, op, x: Tensor, w: Tensor, b: Tensor) -> Tensor:
        """``op(x, w, b)`` in this precision."""
        return op(x, w, b) if self.kind is None else self.act(_LowOp.apply(x, w, b, op, self.kind))

    def act(self, t: Tensor) -> Tensor:
        """``t`` as this precision holds it."""
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


def _norm(x: Tensor, sd: Dict[str, Tensor], key: str, kind: str, groups: int, train: bool,
          prec: Precision) -> Tensor:
    if kind == "group":
        return prec.act(F.group_norm(x, min(groups, x.shape[1]), sd[f"{key}.weight"], sd[f"{key}.bias"], eps=BN_EPS))
    mean_, var_ = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
    if train:  # batch statistics; the running ones move toward them (the variance unbiased)
        dims = (0, 2, 3, 4)
        mean, var = x.mean(dims), x.var(dims, unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            mean_.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            var_.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))
    else:
        mean, var = mean_, var_
    mult = sd[f"{key}.weight"] * torch.rsqrt(var + BN_EPS)
    shift = sd[f"{key}.bias"] - mean * mult
    view = (1, -1, 1, 1, 1)
    return prec.act(x * prec.act(mult).view(view) + prec.act(shift).view(view))


def _conv3(x, w, b):
    return F.conv3d(x, w, b, padding=1)


def _up(x, w, b):
    return F.conv_transpose3d(x, w, b, stride=2)


def _double_conv(x, sd, key, kind, groups, train, prec):
    for i in (0, 3):
        x = prec(_conv3, x, sd[f"{key}.{i}.weight"], sd[f"{key}.{i}.bias"])
        x = F.relu(_norm(x, sd, f"{key}.{i + 1}", kind, groups, train, prec))
    return x


def _pad_to(x: Tensor, shape) -> Tensor:
    pads = []
    for ax in (4, 3, 2):
        diff = shape[ax - 2] - x.shape[ax]
        pads += [diff // 2, diff - diff // 2]
    return F.pad(x, pads) if any(pads) else x


def forward(sd: Dict[str, Tensor], x: Tensor, norm: str = "batch", groups: int = 8, train: bool = False,
            prec: Precision = FP32) -> Tensor:
    """Logits (N, K, D, H, W) of images (N, C, D, H, W)."""
    enc = [_double_conv(x, sd, "inc.conv", norm, groups, train, prec)]
    for i in range(1, 5):
        enc.append(_double_conv(F.max_pool3d(enc[-1], 2), sd, f"down{i}.maxpool_conv.1.conv", norm, groups,
                                train, prec))
    x = enc[4]
    for i, skip in zip(range(1, 5), enc[3::-1]):
        x = prec(_up, x, sd[f"up{i}.up.weight"], sd[f"up{i}.up.bias"])
        x = torch.cat([skip, _pad_to(x, skip.shape[2:])], 1)
        x = _double_conv(x, sd, f"up{i}.conv.conv", norm, groups, train, prec)
    return prec(F.conv3d, x, sd["outc.weight"], sd["outc.bias"])


def probabilities(logits: Tensor) -> Tensor:
    """Sigmoid of a binary head, softmax over the classes otherwise."""
    return torch.sigmoid(logits) if logits.shape[1] == 1 else torch.softmax(logits, 1)


# ---- losses (global flatten over the microbatch, smooth 1) ----------------------


def dice_loss(logits: Tensor, labels: Tensor, smooth: float = 1.0) -> Tensor:
    p, t = torch.sigmoid(logits), labels.float()
    return 1.0 - (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


def bce_dice_loss_kclass(logits: Tensor, labels: Tensor, smooth: float = 1.0) -> Tensor:
    """0.5 · softmax cross-entropy + 0.5 · soft Dice over the foreground
    classes 1..K−1; ``labels`` (N, D, H, W) class ids."""
    k = logits.shape[1]
    ce = F.cross_entropy(logits, labels.long())
    p = torch.softmax(logits, 1)
    t = F.one_hot(labels.long(), k).permute(0, 4, 1, 2, 3).float()
    dims = (0, 2, 3, 4)
    dice = (2.0 * (p * t).sum(dims) + smooth) / (p.sum(dims) + t.sum(dims) + smooth)
    return 0.5 * ce + 0.5 * (1.0 - dice[1:].mean())


LOSSES = {"dice": dice_loss, "bce_dice": bce_dice_loss_kclass}


# ---- the train step ---------------------------------------------------------------


class Adam:
    """Adam with coupled L2 (the decay added to the gradient before the
    moments), after clipping the gradients by their global norm."""

    def __init__(self, params: Dict[str, Tensor], lr, betas, eps, weight_decay, clip):
        self.params, self.lr, (self.b1, self.b2), self.eps, self.wd, self.clip = params, lr, betas, eps, \
            weight_decay, clip
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> Tensor:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        scale = self.clip / norm if self.clip > 0 and norm >= self.clip else torch.ones_like(norm)
        self.t += 1
        for k, p in self.params.items():
            g = grads[k] * scale + self.wd * p
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return norm


def is_param(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var", "num_batches_tracked"))


def train_steps(state: Dict[str, Tensor], batches: List[tuple], cfg: dict, prec: Precision = FP32):
    """Run ``cfg``'s train step over ``batches`` [(images (B, D, H, W, C),
    labels (B, D, H, W, 1)), ...] from ``state`` (changed in place): the
    batch as ``accum_steps`` microbatches in order, their gradients summed
    and divided by ``accum_steps``, then clip and Adam. Returns (the step
    losses, the gradient as Adam took it at step 1, per leaf)."""
    params = {k: v.requires_grad_(True) for k, v in state.items() if is_param(k)}
    opt = Adam(params, cfg["learning_rate"], tuple(cfg["betas"]), cfg["eps"], cfg["weight_decay"],
               cfg["grad_clip_norm"])
    loss_fn = LOSSES[cfg["loss"]]
    accum = cfg["accum_steps"]
    losses, first_grad = [], None
    for images, labels in batches:
        micro = images.shape[0] // accum
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        total = 0.0
        for i in range(accum):
            x = images[i * micro:(i + 1) * micro].float().permute(0, 4, 1, 2, 3).contiguous()
            y = labels[i * micro:(i + 1) * micro, ..., 0]
            logits = forward(state, x, cfg["norm_layer"], cfg["group_norm_groups"], train=True, prec=prec)
            loss = loss_fn(logits, y if cfg["n_classes"] > 1 else y[:, None])
            g = torch.autograd.grad(loss, list(params.values()))
            for k, gi in zip(params, g):
                grads[k] += gi
            total += float(loss.detach())
            del logits, loss, g
        for k in grads:
            grads[k] /= accum
        opt.step(grads)
        if first_grad is None:  # what Adam took: m₁ / (1 − β₁)
            first_grad = {k: m / (1 - opt.b1) for k, m in opt.m.items()}
        losses.append(total / accum)
    for p in params.values():
        p.requires_grad_(False)
    return losses, first_grad


# ---- serving ------------------------------------------------------------------------

FLIPS = [tuple(ax for ax, on in zip((2, 3, 4), (d, h, w)) if on)
         for d in (False, True) for h in (False, True) for w in (False, True)]


@torch.no_grad()
def ensemble_probabilities(members: List[Dict[str, Tensor]], x: Tensor, norm: str = "batch", groups: int = 8,
                           tta: bool = True, prec: Precision = FP32) -> Tensor:
    """The members' mean probability over the 8 flips (N, K, D, H, W), each
    member unfolded in eval mode."""
    total, count = None, 0
    for sd in members:
        for axes in (FLIPS if tta else [()]):
            xi = torch.flip(x, axes) if axes else x
            p = probabilities(forward(sd, xi, norm, groups, train=False, prec=prec))
            p = torch.flip(p, axes) if axes else p
            total = p if total is None else total + p
            count += 1
    return total / count


def percentile_normalize(a, lo_q: float = 1.0, hi_q: float = 99.0):
    """A raw volume clipped to its percentiles (linear interpolation) and
    scaled to [0, 1], 0 where they are equal; numpy in, float32 numpy out."""
    import numpy as np

    lo, hi = np.percentile(a.astype(np.float64), [lo_q, hi_q])
    x = np.clip(a.astype(np.float64), lo, hi)
    return ((x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)).astype(np.float32)
