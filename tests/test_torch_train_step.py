"""Port's train and eval steps (train/steps.py) against the JAX package's
``make_train_step`` / ``make_eval_step``, float32 on the CPU.

Both start from the same JAX-initialised weights (carried over with
``state_dict_from_jax_params``) and take 3 steps on the same numpy batch.
Tolerances: the loss per step to rtol 1e-5. The pre-clip ``grad_norm`` at
the first step, from identical weights, to rtol 2e-4, because XLA's jitted
fp32 gradient on the CPU is itself that far from the same step evaluated in
float64 (7e-5 here, where the port's fp32 norm is within 2e-7). At later
steps the weights differ by that rounding, and the norm of this tiny net's
gradient (BatchNorm over 16 values per channel at the bottleneck) moves by
up to 3e-3 for it while the loss does not: rtol 1e-2 there. The params and
BN running statistics after the steps to atol 2e-5 (measured 1.05e-5), and
every such leaf must have moved by at least 5x that (the slowest, ``outc.bias``
in ``accum2_padded``, by 7x; in ``default_eps`` every element moves by about
lr, 50x). The biases
of the 3³ convs, which BatchNorm follows, are held to |Δ| ≤ 2·lr·steps:
their true gradient is 0, the computed one is rounding noise, and Adam
scales noise up to about ±lr per step. Eval Dice/IoU count thresholded
voxels, so a logit within rounding of the threshold moves them by one
voxel's share: atol 1e-4.

Most variants run Adam with eps 1e-2, so that an element whose gradient is
rounding noise moves by about lr·g/eps and three steps stay comparable. The
``default_eps`` variant runs the config's own optimizer (eps 1e-8, weight
decay 1e-5) for one step from identical weights: there, every element whose
gradient is within rounding of 0 moves by ±lr in either package, so a few
hundred of the 350k weights differ by up to 2·lr. JAX shows the same spread
against itself when the batch's two samples are swapped (451 such elements
measured, the port 320 against JAX). So every element is held to 2·lr, and
in each leaf the port may differ from JAX beyond the atol on at most
2·n + 2 elements, n being the count by which JAX differs from itself with
the samples swapped. ``test_optimizer_matches_optax_on_given_gradients``
holds the update itself (clip, coupled L2, Adam at eps 1e-8) to JAX's on the
same gradients, element by element.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcmseg_tpu.core.config import get_config
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train import steps as jax_steps
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train import steps
from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

STEPS = 3
LR = 1e-3
# 32³: the 4-level U-Net's bottleneck is then 2³ voxels per sample; at 16³
# it is one voxel, and BatchNorm over the batch's 2 values there has a true
# gradient of 0 whose computed value is amplified rounding noise
SIZE = 32
# Adam's eps well above the gradients' rounding noise: with the default
# 1e-8, an element whose gradient is fp32 noise (different in XLA and in
# PyTorch) moves by ±lr either way, so the comparison would measure noise;
# with 1e-2 such an element moves by about lr·g/eps. The weight decay is
# large enough that coupled L2 and AdamW would differ.
ADAM_EPS = 1e-2
WEIGHT_DECAY = 1e-2
ATOL = 2e-5
# each tightly held leaf moved by at least this much (its largest element)
MOVED = 5 * ATOL
BN_PRECEDED_BIAS = re.compile(r"conv\.[03]\.bias$")
DEFAULTS = get_config()

VARIANTS = {
    "accum1": dict(),
    "accum1_padded": dict(weight=(1.0, 0.0)),
    "accum2": dict(accum_steps=2, batch_size=4),
    "accum2_padded": dict(accum_steps=2, batch_size=4, weight=(1.0, 1.0, 1.0, 0.0)),
    "ema": dict(ema_decay=0.9),
    "clip_active": dict(grad_clip_norm=0.05),
    # the config's optimizer, one step, with JAX's own spread as the witness
    "default_eps": dict(eps=DEFAULTS.eps, weight_decay=DEFAULTS.weight_decay, steps=1, witness=True),
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(**kw):
    for key in ("weight", "steps", "witness"):
        kw.pop(key, None)
    kw = dict(dict(eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, batch_size=2), **kw)
    return get_config(base_features=4, remat=False, compute_dtype="float32", conv_lowering="lax",
                      target_size=(SIZE,) * 3, learning_rate=LR, **kw)


def _init():
    """JAX-initialised variables (numpy), a train batch of 4 and an eval batch of 2."""
    model = JaxUNet3D.from_config(_config())
    variables = jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False)
    )(jax.random.key(0))
    rng = np.random.default_rng(1)
    # non-trivial BN affine and conv biases (the init's exact 1s and 0s)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).startswith("['params']") and a.ndim == 1
        else np.asarray(a),
        jax.device_get(variables),
    )
    z, y, x = np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij")
    blob = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 80).astype(np.float32)
    batches = []
    for n in (4, 2):
        image = rng.normal(size=(n, SIZE, SIZE, SIZE, 5)).astype(np.float32)
        image[..., 0] += 2.0 * blob
        label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(n)])[..., None]
        batches.append({"image": image, "label": label})
    return variables, batches


@pytest.fixture(scope="module")
def init():
    return _init()


def _jax_state(config, variables):
    model = JaxUNet3D.from_config(config)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_steps.TrainState.create(
        apply_fn=model.apply,
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        ema_params=jax.tree.map(jnp.copy, params) if config.ema_decay > 0 else {},
        tx=jax_steps.make_optimizer(config),
    )
    return model, state


def _port_state(config, variables):
    model = UNet3D.from_config(config, device="meta")
    model.load_state_dict(
        state_dict_from_jax_params(variables["params"], variables["batch_stats"]), strict=True, assign=True
    )
    return model, steps.create_train_state(model, config)


def _sd(variables, stats=None):
    return state_dict_from_jax_params(jax.device_get(variables), stats and jax.device_get(stats))


def _assert_state_close(got, want, steps_taken, what, init=None, witness=None):
    """``got`` equals ``want`` leaf by leaf (see the module docstring); with
    ``init``, every tightly held leaf moved by at least MOVED; with
    ``witness`` (JAX's own state from the reordered batch), elements may
    differ by up to 2·lr·steps as often as JAX differs from itself."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        d = np.abs(g - w)
        if BN_PRECEDED_BIAS.search(k):
            assert d.max() <= 2 * LR * steps_taken, f"{what} {k}"
            continue
        if witness is None:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{what} {k}")
        else:
            n_self = int((np.abs(witness[k].numpy() - w) > ATOL).sum())
            assert d.max() <= 2 * LR * steps_taken, f"{what} {k}"
            assert int((d > ATOL).sum()) <= 2 * n_self + 2, f"{what} {k}: {int((d > ATOL).sum())} vs JAX's {n_self}"
        if init is not None:
            assert np.abs(w - init[k].numpy()).max() >= MOVED, f"{what} {k} barely moved"


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def trained(request, init):
    """(variant, config, steps taken, JAX state + metrics, port model + state
    + metrics, witness) after the variant's steps. The witness, where the
    variant asks for it, is the JAX state after the same steps on the batch
    with its samples in reverse order, which changes only the rounding."""
    variables, batches = init
    kw = VARIANTS[request.param]
    config = _config(**kw)
    n_steps = kw.get("steps", STEPS)
    batch = {k: v[: config.batch_size] for k, v in batches[0].items()}
    if "weight" in kw:
        batch["weight"] = np.asarray(kw["weight"], np.float32)
    jmodel, _ = _jax_state(config, variables)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, config))

    def run_jax(b):
        jstate, jmetrics = _jax_state(config, variables)[1], []
        for _ in range(n_steps):
            jstate, m = jstep(jstate, b)
            jmetrics.append({k: float(v) for k, v in m.items()})
        return jstate, jmetrics

    jstate, jmetrics = run_jax(batch)
    witness = run_jax({k: v[::-1].copy() for k, v in batch.items()})[0] if kw.get("witness") else None
    model, state = _port_state(config, variables)
    step = steps.make_train_step(model, config)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, tbatch).items()} for _ in range(n_steps)]
    return request.param, config, n_steps, (jmodel, jstate, jmetrics), (model, state, metrics), witness


def test_loss_and_grad_norm_match_jax_per_step(trained):
    variant, config, n_steps, (_, _, jmetrics), (_, _, metrics), _ = trained
    assert len(metrics) == len(jmetrics) == n_steps
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"{variant} step {i}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4 if i == 0 else 1e-2,
                                   err_msg=f"{variant} step {i}")
    if variant == "clip_active":
        assert all(m["grad_norm"] > config.grad_clip_norm for m in metrics)
    else:
        assert all(m["grad_norm"] < config.grad_clip_norm for m in metrics)


def test_params_and_batch_stats_match_jax(trained, init):
    variant, _, n_steps, (_, jstate, _), (model, state, _), witness = trained
    want = _sd(jstate.params, jstate.batch_stats)
    got = model.state_dict()
    assert state.step == n_steps and int(jstate.step) == n_steps
    for k in [k for k in got if k.endswith("num_batches_tracked")]:
        assert int(got.pop(k)) == n_steps * (2 if "accum2" in variant else 1)
        want.pop(k)
    init_sd = _sd(init[0]["params"], init[0]["batch_stats"])
    witness_sd = witness and _sd(witness.params, witness.batch_stats)
    _assert_state_close(got, want, n_steps, variant, init=init_sd, witness=witness_sd)
    if variant == "ema":
        _assert_state_close(state.ema, _sd(jstate.ema_params), n_steps, "ema")


@pytest.mark.parametrize("max_norm", [1.0, 0.1], ids=["clip_inactive", "clip_active"])
def test_optimizer_matches_optax_on_given_gradients(init, max_norm):
    """``apply_gradients`` (clip, coupled L2, Adam) against flax's
    ``TrainState.apply_gradients`` over the JAX chain, at the config's Adam
    eps and weight decay, on the same random gradients for 3 steps. The
    gradients have a global norm of 0.5 and per-leaf scales spread over five
    decades, so the smallest elements sit near eps. Every element to atol
    2.5e-7 (two fp32 ulps of a parameter near 1), and every leaf moved by at
    least 10x that on average."""
    variables, _ = init
    config = _config(eps=DEFAULTS.eps, weight_decay=DEFAULTS.weight_decay, grad_clip_norm=max_norm)
    _, jstate = _jax_state(config, variables)
    model, state = _port_state(config, variables)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    rng = np.random.default_rng(2)
    scales = 10.0 ** rng.uniform(-5, 0, len(leaves))
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    for i in range(STEPS):
        raw = [s * rng.normal(size=leaf.shape) for s, leaf in zip(scales, leaves)]
        total = np.sqrt(sum(float(np.sum(r * r)) for r in raw))
        grads = jax.tree_util.tree_unflatten(treedef, [(0.5 / total * r).astype(np.float32) for r in raw])
        tgrads = _sd(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        norm = float(steps.apply_gradients(state, config.grad_clip_norm))
        jstate = apply(jstate, grads)
        np.testing.assert_allclose(norm, float(optax.global_norm(grads)), rtol=1e-5, err_msg=f"step {i}")
    assert state.step == int(jstate.step) == STEPS
    want = _sd(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=2.5e-7, err_msg=name)
        assert np.abs(want[name].numpy() - before[name].numpy()).mean() >= 2.5e-6, f"{name} barely moved"


def test_eval_step_matches_jax(trained, init):
    """In ``default_eps`` a few hundred weights differ from JAX's by up to
    2·lr, as JAX's own do with the samples swapped, and a voxel near the
    threshold may flip: Dice/IoU to 3e-4 there (measured 1.1e-4)."""
    variant, config, _, (jmodel, jstate, _), (model, state, _), witness = trained
    batch = dict(init[1][1], weight=np.asarray([1.0, 0.0], np.float32))
    want = jax.jit(jax_steps.make_eval_step(jmodel, config))(jstate, batch)
    got = steps.make_eval_step(model, config)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-5)
    atol = 3e-4 if witness is not None else 1e-4
    for k in ("dice", "iou", "dice_sum", "iou_sum", "weight_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol, err_msg=k)


def test_clip_follows_optax_formula():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = steps.global_norm(g)
    assert norm.item() == pytest.approx(13.0)
    steps.clip_by_global_norm_(g, norm, 1.0)
    torch.testing.assert_close(g[0], torch.tensor([3.0, 4.0]) / 13.0 * 1.0)
    unclipped = [torch.tensor([0.3, 0.4])]
    steps.clip_by_global_norm_(unclipped, steps.global_norm(unclipped), 1.0)
    assert torch.equal(unclipped[0], torch.tensor([0.3, 0.4]))  # untouched, no + 1e-6


def test_learning_rate_lives_in_the_param_group():
    config = _config()
    state = steps.create_train_state(UNet3D.from_config(config), config)
    assert steps.get_learning_rate(state) == pytest.approx(LR)
    steps.set_learning_rate(state, 5e-5)
    assert all(g["lr"] == 5e-5 for g in state.optimizer.param_groups)
    assert state.optimizer.defaults["weight_decay"] == config.weight_decay  # coupled L2, not AdamW
