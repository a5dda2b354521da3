"""Parameters in a 16-bit dtype (``param_dtype`` 'bfloat16' or 'float16')
and the compute dtypes of the conv kernels, the port against the JAX
package on the CPU.

The optimizer alone (``steps.Adam16`` after optax's clip and global norm),
on the same 16-bit gradients as optax's chain under flax's
``apply_gradients``: bf16 bit for bit over 3 steps, the clip active and
not (XLA's bf16 arithmetic on the CPU rounds after every operation, as the
port does); fp16 one step, every element within 2 ulps (XLA's fused fp16
code contracts a product and a sum into one fma where its LLVM backend
chooses to, which the port follows where the HLO shows it: measured 166 of
354,381 parameters 1 ulp apart, the moments bit for bit).

The train step from the same JAX-initialised 16-bit weights
(``state_dict_from_jax_params`` carries them across) on the same seeded
batch, base 4 at 32³, Adam eps 1e-2 and weight decay 1e-2 as in
``tests/test_torch_train_step.py`` (there, why). Three variants: compute
fp32 with bf16 params (and an EMA), compute fp32 with fp16 params, where
the params' rounding is all that differs from the fp32 tests; and compute
bf16 with bf16 params. With bf16 compute the two frameworks round
activations at other places, and JAX's bf16 gradients lie further from
the fp32 ones than the port's do (relative L2 of Adam's first moment
after step 1, from JAX's fp32-compute step with the same bf16 params:
JAX 0.29, the port 0.11), so the port's moments are 1 ulp or more from
JAX's on 80% of their elements where JAX against itself with the batch's
samples swapped has 22% (ROADMAP queue C). That variant holds its loss to
JAX's, its parameters to JAX's in ulps at the share measured, and its
gradient norm, moments, parameter changes and running statistics to
JAX's fp32-compute step, no further from it than BF16_MARGIN times JAX's
bf16 step is. Distances
of 16-bit values are counted in ulps of their dtype, and the conv biases
that BatchNorm follows (true gradient 0: their gradients, moments and steps
are rounding noise) are held in absolute terms, as the fp32 tests hold them.

The rest of the port with 16-bit params on the CPU: a JAX bf16 tree carried
across, the ``.pth`` round trip, the BN fold, a Trainer (resumed bit for
bit), CV, the Validator, the Predictor and ``export``; the tensor-parallel
clip norm on a thread group; data, spatial and tensor parallel gloo clusters
of 2 processes against one process (the workers are this file:
``python tests/test_torch_param_dtype.py PID NPROC PORT INPUTS OUT``); the
kernels' dtype dispatch; and the dtypes refused by name.
"""

import copy
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
STEPS = 3
LR = 1e-3
ADAM_EPS = 1e-2
WEIGHT_DECAY = 1e-2
BN_PRECEDED_BIAS = re.compile(r"conv\.[03]\.bias$")
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
# one ulp at 1.0 of each 16-bit dtype
EPS16 = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}

VARIANTS = {
    "f32_bf16": dict(compute_dtype="float32", param_dtype="bfloat16", ema_decay=0.9),
    "f32_f16": dict(compute_dtype="float32", param_dtype="float16"),
    # held against JAX's step and JAX's step with fp32 compute (``exact``)
    "bf16_bf16": dict(compute_dtype="bfloat16", param_dtype="bfloat16", exact="float32"),
}
# fp32 compute, after steps 1 and 3: the grad norm's distance in ulps, the
# share of Adam's moments beyond (so many) ulps after step 1, the
# parameters' largest distance and share beyond one ulp after step 3, and the running
# statistics' largest distance (the tests' docstrings give what was measured)
BOUNDS = dict(norm_ulps=(1, 4), moments=(1, 0.05), params3=(64, 5e-3), stats=(1e-5, 5e-4))
# bf16 compute: the share of the parameters beyond one ulp of JAX's after
# steps 1 and 3; and the port's distance from JAX's fp32-compute step may be
# this many times JAX's bf16 step's (chip_smoke.py's BF16_MARGIN)
BF16_PARAMS_SHARE = (1e-2, 3e-2)
BF16_MARGIN = 1.5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit tensor's bits as integers in the order of its values."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in ulps of ``got``'s 16-bit dtype (NaN to NaN: 0)."""
    want = want.to(got.dtype)
    d = (_ordered(got) - _ordered(want)).abs()
    return torch.where(torch.isnan(got) & torch.isnan(want), 0, d)


def _config(for_port=False, **kw):
    """The JAX package's config (the port's with ``for_port=True``)."""
    if for_port:
        from pcmseg_tpu_torch.core.config import get_config
    else:
        from pcmseg_tpu.core.config import get_config

    kw = {k: v for k, v in kw.items() if k != "exact"}
    kw = dict(dict(eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, batch_size=2, learning_rate=LR,
                   target_size=(SIZE,) * 3), **kw)
    return get_config(base_features=4, remat=False, conv_lowering="lax", **kw)


def _init(param_dtype: str, rows: int = 2):
    """JAX-initialised variables (numpy, params in ``param_dtype``) with
    non-trivial 1-D params, and a train batch of ``rows`` (the first rows
    of a longer batch are the shorter one)."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D.from_config(_config(param_dtype=param_dtype))
    variables = jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False)
    )(jax.random.key(0))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        if jax.tree_util.keystr(path).startswith("['params']") and a.ndim == 1
        else np.asarray(a),
        jax.device_get(variables),
    )
    z, y, x = np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij")
    blob = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 80).astype(np.float32)
    image = rng.normal(size=(rows, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(rows)])[..., None]
    return variables, {"image": image, "label": label}


def _sd(params, stats=None):
    import jax

    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    return state_dict_from_jax_params(jax.device_get(params), stats and jax.device_get(stats))


def _port_model(config, variables):
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    model = UNet3D.from_config(config, device="meta")
    model.load_state_dict(state_dict_from_jax_params(variables["params"], variables["batch_stats"]),
                          strict=True, assign=True)
    return model


def _jax_run(config, variables, batch, n_steps):
    """[(params, batch stats, mu, nu, ema, metrics) after each step] of JAX's step."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.train import steps as jax_steps

    model = JaxUNet3D.from_config(config)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_steps.TrainState.create(
        apply_fn=model.apply, params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        ema_params=jax.tree.map(jnp.copy, params) if config.ema_decay > 0 else {},
        tx=jax_steps.make_optimizer(config),
    )
    step, out = jax.jit(jax_steps.make_train_step(model, config)), []
    for _ in range(n_steps):
        state, m = step(state, batch)
        adam = state.opt_state.inner_state[-3]
        out.append(dict(
            params=_sd(state.params), stats=_sd(state.params, state.batch_stats), mu=_sd(adam.mu), nu=_sd(adam.nu),
            ema=_sd(state.ema_params) if config.ema_decay > 0 else None, count=int(adam.count),
            lr=float(state.opt_state.hyperparams["learning_rate"]),
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), grad_norm_dtype=str(m["grad_norm"].dtype),
        ))
    return out


def _port_run(config, variables, batch, n_steps):
    from pcmseg_tpu_torch.train import steps

    model = _port_model(config, variables)
    state = steps.create_train_state(model, config)
    step, names, out = steps.make_train_step(model, config), dict(model.named_parameters()), []
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(n_steps):
        m = step(state, tbatch)
        opt = {p: {k.replace("exp_avg_sq", "nu").replace("exp_avg", "mu"): v for k, v in s.items()}
               for p, s in state.optimizer.state.items()}
        out.append(dict(
            params={k: p.detach().clone() for k, p in names.items()}, stats=copy.deepcopy(model.state_dict()),
            mu={k: opt[p]["mu"].clone() for k, p in names.items()}, nu={k: opt[p]["nu"].clone() for k, p in names.items()},
            ema=None if state.ema is None else {k: v.clone() for k, v in state.ema.items()},
            count=int(opt[names["outc.bias"]]["step"]), lr=steps.get_learning_rate(state),
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), grad_norm_dtype=str(m["grad_norm"].dtype),
        ))
    return out


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def stepped(request):
    """(variant, JAX's and the port's records of each of 3 steps, and, for
    a variant with an ``exact`` compute dtype, {"steps": JAX's records from
    the same weights computed in that dtype, "params": those weights})."""
    kw = VARIANTS[request.param]
    variables, batch = _init(kw["param_dtype"])
    jax_out = _jax_run(_config(**kw), variables, batch, STEPS)
    port_out = _port_run(_config(for_port=True, **kw), variables, batch, STEPS)
    exact = None
    if "exact" in kw:
        exact = dict(steps=_jax_run(_config(**dict(kw, compute_dtype=kw["exact"])), variables, batch, STEPS),
                     params=_sd(variables["params"]))
    return request.param, jax_out, port_out, exact


def test_loss_and_grad_norm_match_jax(stepped):
    """After steps 1 and 3: the loss within the param dtype's resolution
    (one ulp at 1.0) of JAX's; ``grad_norm`` in the param dtype, as
    ``optax.global_norm`` returns it, within 1 ulp of JAX's after step 1
    and 4 after step 3 (measured: bf16 equal at both, fp16 equal and 3
    ulps, where JAX against itself with the samples swapped is 1 ulp
    apart); with bf16 compute, no further from JAX's fp32-compute norm
    than BF16_MARGIN times JAX's bf16 norm is, plus one ulp (measured:
    the port 0.0039 and 0.0020 from it, JAX 0.0176 and 0.0195); the step
    count and the learning rate in the param dtype as JAX holds them."""
    variant, jax_out, port_out, exact = stepped
    dtype = DTYPES[VARIANTS[variant]["param_dtype"]]
    for n, i in enumerate((0, STEPS - 1)):
        got, want = port_out[i], jax_out[i]
        assert got["grad_norm_dtype"] == f"torch.{want['grad_norm_dtype']}"
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=EPS16[dtype], err_msg=f"step {i + 1}")
        ulp = EPS16[dtype] * 2.0 ** np.floor(np.log2(want["grad_norm"]))
        if exact is None:
            assert abs(got["grad_norm"] - want["grad_norm"]) <= BOUNDS["norm_ulps"][n] * ulp, (
                i, got["grad_norm"], want["grad_norm"])
        else:
            norm = exact["steps"][i]["grad_norm"]
            assert abs(got["grad_norm"] - norm) <= BF16_MARGIN * abs(want["grad_norm"] - norm) + ulp, (
                i, got["grad_norm"], want["grad_norm"], norm)
        assert got["count"] == want["count"] == i + 1
        assert got["lr"] == want["lr"] == float(torch.tensor(LR, dtype=dtype))


def _beyond(got, want, bound=1):
    """(largest distance in ulps, count beyond ``bound`` ulps, count) over
    the tightly held leaves (not the BN-preceded conv biases)."""
    d = torch.cat([ulps(got[k], want[k]).reshape(-1) for k in want if not BN_PRECEDED_BIAS.search(k)])
    return int(d.max()), int((d > bound).sum()), d.numel()


def _distance(got, want, base=None):
    """‖got − want‖ / ‖want‖ in float64 over the tightly held leaves (of
    their changes from ``base`` where given)."""
    num = den = 0.0
    for k in want:
        if BN_PRECEDED_BIAS.search(k):
            continue
        a, b = got[k].double(), want[k].double()
        if base is not None:
            a, b = a - base[k].double(), b - base[k].double()
        num, den = num + float(((a - b) ** 2).sum()), den + float((b**2).sum())
    return (num / den) ** 0.5


def test_params_and_moments_match_jax(stepped):
    """Every parameter and moment in the param dtype, the BN-preceded conv
    biases within 2·lr·steps of JAX's. With fp32 compute: after step 1
    every parameter equal to JAX's or one ulp apart (measured: 16 of
    354,013 bf16 and 184 fp16 parameters one ulp apart), and Adam's moments
    beyond one ulp on at most 5% of the elements (a moment of a gradient
    near 0 is far apart in ulps and close in value; JAX against itself with
    the batch's samples swapped: 24% of mu's and 42% of nu's elements with
    bf16 params; the port from JAX 0.8% and 2.1%). After step 3, where each
    step's gradient moves with the last step's params, at most 0.5% of the
    parameters beyond one ulp and none beyond 64 (measured bf16 0.07% and
    24 ulps, fp16 0.4% and 42 ulps; JAX against itself with the samples
    swapped 0.06% and 0.16%).

    With bf16 compute, against JAX's bf16 step: after steps 1 and 3 at most
    1% and 3% of the parameters beyond one ulp (measured 0.63% and 2.1%;
    JAX against itself with the samples swapped 0.015% and 1.1%). Its
    moments are not held in ulps: 80% of mu's elements lie beyond one ulp
    of JAX's after step 1, JAX against itself with the samples swapped
    22%. Instead mu, nu and the parameters' changes are held, in relative
    L2, no further from JAX's fp32-compute step than BF16_MARGIN times
    JAX's bf16 step is (measured after step 1: mu 0.105 against JAX's
    0.286, nu 0.090 against 0.371, the changes 0.42 against 0.80; after
    step 3: 0.069 / 0.278, 0.046 / 0.342, 0.28 / 0.73)."""
    variant, jax_out, port_out, exact = stepped
    dtype = DTYPES[VARIANTS[variant]["param_dtype"]]
    bound, share = BOUNDS["moments"]
    for n, i in enumerate((0, STEPS - 1)):
        got, want = port_out[i], jax_out[i]
        for what in ("params", "mu", "nu"):
            assert all(t.dtype == dtype for t in got[what].values()), what
        for k in want["params"]:
            if BN_PRECEDED_BIAS.search(k):
                d = float((got["params"][k].double() - want["params"][k].double()).abs().max())
                assert d <= 2 * LR * (i + 1) * 1.01, (k, d)
        worst, beyond, total = _beyond(got["params"], want["params"])
        if exact is not None:
            assert beyond <= BF16_PARAMS_SHARE[n] * total, (i, beyond, total)
            for what, base in (("params", exact["params"]), ("mu", None), ("nu", None)):
                ref = exact["steps"][i][what]
                mine, theirs = _distance(got[what], ref, base), _distance(want[what], ref, base)
                assert mine <= BF16_MARGIN * theirs, (i, what, mine, theirs)
        elif i == 0:
            assert worst <= 1, (variant, worst)
            for mom in ("mu", "nu"):
                far = _beyond(got[mom], want[mom], bound)
                assert far[1] <= share * total, (variant, mom, far)
        else:
            most, share3 = BOUNDS["params3"]
            assert worst <= most and beyond <= share3 * total, (variant, worst, beyond)


def test_batch_stats_stay_fp32_and_match_jax(stepped):
    """BatchNorm's running statistics stay fp32 (``norm.py:47-52``) whatever
    the param dtype: within 1e-5 of JAX's after step 1 (measured 1.4e-6 and
    2.1e-6; JAX against itself with the samples swapped 1.8e-6 and 3.8e-6),
    5e-4 after step 3 (1.2e-4 and 4.7e-5: the forwards' params differ by
    the ulps above); with bf16 compute, the largest distance from JAX's
    fp32-compute step no more than BF16_MARGIN times JAX's bf16 step's,
    plus 1e-6 (measured 1.54e-3 against 1.51e-3 after step 1, 2.98e-3
    against 4.26e-3 after step 3)."""
    variant, jax_out, port_out, exact = stepped
    for n, i in enumerate((0, STEPS - 1)):
        got, want = port_out[i]["stats"], jax_out[i]["stats"]
        keys = [k for k in want if "running" in k]
        assert all(got[k].dtype == torch.float32 for k in keys)
        far = lambda a, b: max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)  # noqa: E731
        if exact is None:
            assert far(got, want) <= BOUNDS["stats"][n], (i, far(got, want))
        else:
            ref = exact["steps"][i]["stats"]
            assert far(got, ref) <= BF16_MARGIN * far(want, ref) + 1e-6, (i, far(got, ref), far(want, ref))


@pytest.mark.parametrize("stepped", ["f32_bf16"], indirect=True)
def test_ema_of_16_bit_params_is_fp32_as_jax(stepped):
    """JAX's EMA of bf16 params is fp32 from its first step (``d`` is an
    fp32 array, ``steps.py:279-290``), and so is the port's: dtype fp32,
    and every element within one bf16 ulp of its leaf's scale of JAX's
    (the params it averages are that close; measured 2.2e-3)."""
    _, jax_out, port_out, _ = stepped
    for i in (0, STEPS - 1):
        got, want = port_out[i]["ema"], jax_out[i]["ema"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert want[k].dtype == got[k].dtype == torch.float32, k
            if BN_PRECEDED_BIAS.search(k):
                continue
            scale = float(want[k].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= EPS16[torch.bfloat16] * scale, (i, k)


# ---- the optimizer alone, on given 16-bit gradients ----------------------------------


def _given_gradient_run(param_dtype, max_norm, n_steps, **kw):
    """(port state after each step, JAX state after each step, the norms)
    of ``apply_gradients`` and flax's over optax's chain, on the same random
    gradients (global norm 0.5, per-leaf scales over four decades)."""
    import jax
    import jax.numpy as jnp
    import optax

    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.train import steps as jax_steps
    from pcmseg_tpu_torch.train import steps

    kw = dict(param_dtype=param_dtype, grad_clip_norm=max_norm, compute_dtype="float32", **kw)
    config = _config(**kw)
    model = JaxUNet3D.from_config(config)
    variables = jax.device_get(jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, 16, 16, 16, 5)), train=False))(jax.random.key(0)))
    jstate = jax_steps.TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
                                         batch_stats=variables["batch_stats"], ema_params={},
                                         tx=jax_steps.make_optimizer(config))
    port = _port_model(_config(for_port=True, **kw), variables)
    state = steps.create_train_state(port, _config(for_port=True, **kw))
    names = dict(port.named_parameters())
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    rng = np.random.default_rng(2)
    scales = 10.0 ** rng.uniform(-4, 0, len(leaves))
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    out = []
    for _ in range(n_steps):
        raw = [s * rng.normal(size=leaf.shape) for s, leaf in zip(scales, leaves)]
        total = np.sqrt(sum(float(np.sum(r * r)) for r in raw))
        grads = jax.tree_util.tree_unflatten(treedef, [(0.5 / total * r).astype(leaf.dtype)
                                                       for r, leaf in zip(raw, leaves)])
        given = _sd(grads)
        for k, p in names.items():
            p.grad = given[k].clone()
        norm = steps.apply_gradients(state, max_norm)
        jstate = apply(jstate, grads)
        adam = jstate.opt_state.inner_state[-3]
        out.append((
            {k: p.detach().clone() for k, p in names.items()},
            {k: state.optimizer.state[p]["mu"].clone() for k, p in names.items()},
            {k: state.optimizer.state[p]["nu"].clone() for k, p in names.items()},
            _sd(jstate.params), _sd(adam.mu), _sd(adam.nu), norm, float(jax.jit(optax.global_norm)(grads)),
        ))
    return out


@pytest.mark.parametrize("max_norm", [1.0, 0.1], ids=["clip_inactive", "clip_active"])
def test_bf16_optimizer_is_optax_bit_for_bit(max_norm):
    """bf16 params: the global norm (summed in bf16 in ``jax.tree.leaves``'
    order), the clip, coupled L2, Adam's moments and the update equal to
    optax's bit for bit over 3 steps, at the config's eps 1e-8 and weight
    decay 1e-5, the clip active and not."""
    from pcmseg_tpu.core.config import get_config

    defaults = get_config()
    for i, (p, mu, nu, jp, jmu, jnu, norm, jnorm) in enumerate(
            _given_gradient_run("bfloat16", max_norm, STEPS, eps=defaults.eps, weight_decay=defaults.weight_decay)):
        assert norm.dtype == torch.bfloat16 and float(norm) == jnorm, (i, float(norm), jnorm)
        for got, want, what in ((p, jp, "params"), (mu, jmu, "mu"), (nu, jnu, "nu")):
            for k in want:
                assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k]), (i, what, k)


@pytest.mark.parametrize("max_norm", [1.0, 0.1], ids=["clip_inactive", "clip_active"])
def test_fp16_optimizer_follows_xla_within_2_ulps(max_norm):
    """fp16 params, one step at eps 1e-2 and weight decay 1e-2 (at eps 1e-8,
    which rounds to 0 in fp16, both packages make NaNs where a moment
    underflows): the norm equal to optax's, every parameter and moment
    within 2 ulps of JAX's and at most 0.2% of them apart at all (measured:
    166 parameters 1 ulp apart and the moments equal with the clip
    inactive; with it, 287 parameters and 38,023 of mu's 354,381 elements,
    1 of each 2 ulps apart: XLA fuses the clip's division into its
    product there). ``Adam16`` follows XLA's fused fp16 code because the
    plain path of bf16 (a rounding after every operation, the update as
    ``(mu / bc1) / den``) fails this test: measured, the clip inactive,
    2,771 parameters apart and 72 beyond one ulp, the worst 6, and 36,611
    of mu's elements apart, 2,241 by 2 ulps; the clip active, 1,939
    parameters apart, the worst 3 (nu equal in both)."""
    ((p, mu, nu, jp, jmu, jnu, norm, jnorm),) = _given_gradient_run("float16", max_norm, 1, eps=1e-2, weight_decay=1e-2)
    assert norm.dtype == torch.float16 and float(norm) == jnorm
    total = sum(v.numel() for v in jp.values())
    for got, want, what, share in ((p, jp, "params", 2e-3), (mu, jmu, "mu", 0.11 if max_norm < 1 else 0.0),
                                   (nu, jnu, "nu", 0.0)):
        d = torch.cat([ulps(got[k], want[k]).reshape(-1) for k in want])
        assert int(d.max()) <= 2 and int((d > 0).sum()) <= share * total, (what, int(d.max()), int((d > 0).sum()))


# ---- checkpoints, the bridge and the BN fold ------------------------------------------


def _bf16_tree():
    """A base-4 JAX model's variables with bf16 params (numpy, ml_dtypes)."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D.from_config(_config(param_dtype="bfloat16"))
    variables = jax.device_get(jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, 16, 16, 16, 5)), train=False))(jax.random.key(4)))
    rng = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: (np.abs(rng.normal(1.0, 0.3, a.shape))).astype(np.float32), variables["batch_stats"])
    params = jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape)).astype(a.dtype),
                          variables["params"])
    return params, stats


def test_jax_bf16_tree_carries_across_bit_for_bit():
    """``state_dict_from_jax_params`` takes ml_dtypes' bfloat16 leaves
    (``torch.from_numpy`` refuses them) through their uint16 bits: every
    parameter bf16 and bitwise JAX's, the batch statistics fp32, and the
    state dict loads into a bf16-param model strictly."""
    import jax

    from pcmseg_tpu.train.checkpoints import params_to_torch_state_dict
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    params, stats = _bf16_tree()
    sd = state_dict_from_jax_params(params, stats)
    # JAX's own bridge takes no bf16 leaf (torch.from_numpy): hold the bf16
    # tensors to its fp32 export of the same values, exact both ways
    want = params_to_torch_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), params), stats)
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert v.dtype == (torch.float32 if "running" in k else torch.bfloat16), k
        assert torch.equal(v.float(), torch.as_tensor(np.asarray(want[k]))), k
    model = UNet3D.from_config(get_config(base_features=4, param_dtype="bfloat16"))
    model.load_state_dict(sd, strict=True)
    assert all(torch.equal(p, sd[k]) for k, p in model.named_parameters())


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float16"])
def test_pth_round_trip_keeps_the_param_dtype(param_dtype, tmp_path):
    """``save_pth`` / ``load_pth`` of a 16-bit-param model: every tensor
    back bitwise in its own dtype (params 16-bit, running statistics
    fp32), and ``load_model_state`` serves it in the config's param dtype."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.validate import load_model_state
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth

    config = get_config(base_features=4, param_dtype=param_dtype)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0))
    path = save_pth(str(tmp_path / "m.pth"), model.state_dict(), {"base_features": 4})
    sd, snap = load_pth(path)
    assert snap == {"base_features": 4}
    for k, v in model.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    served, _ = load_model_state(config, path)
    assert {p.dtype for p in served.parameters()} == {DTYPES[param_dtype]}
    wide, _ = load_model_state(get_config(base_features=4), path)
    for (k, p), q in zip(wide.named_parameters(), served.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q.float()), k


def test_bn_fold_of_bf16_params_is_jax_fold():
    """``fold_batchnorm`` of a bf16 state dict: in float64, then cast to the
    conv weight's dtype, as ``pcmseg_tpu/infer/fold_bn.py:28-39`` folds a
    bf16 tree: every folded weight and bias bf16 and bitwise JAX's."""
    from pcmseg_tpu.infer.fold_bn import fold_batchnorm as jax_fold
    from pcmseg_tpu_torch.infer.fold_bn import fold_batchnorm
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    params, stats = _bf16_tree()
    got = fold_batchnorm(state_dict_from_jax_params(params, stats))
    want = state_dict_from_jax_params(jax_fold(params, stats))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k], want[k]), k


# ---- the entry points with bf16 params ------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from pcmseg_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=5, shape=(18, 16, 17), seed=7)
    return root


def _trainer_config(tree, save_dir, **kw):
    from pcmseg_tpu_torch.core.config import get_config

    base = dict(data_dir=tree, save_dir=str(save_dir), cache_dir=str(save_dir) + "_cache", base_features=4,
                compute_dtype="float32", param_dtype="bfloat16", remat=False, target_size=(16, 16, 16),
                batch_size=2, num_epochs=2, early_stopping=False, device_data_cache_gb=0.0, seed=3,
                learning_rate=1e-3, ema_decay=0.9)
    base.update(kw)
    return get_config(**base)


def test_bf16_trainer_resumes_bit_for_bit_and_serves(tree, tmp_path):
    """A 2-epoch bf16-param Trainer (EMA on): its checkpoints keep the
    params, Adam's moments and int32 count in bf16 and the EMA in fp32; a
    run killed after epoch 1 and resumed from ``latest.pt`` ends bitwise
    equal to the uninterrupted one; ``best.pth`` and ``export`` of
    ``best.pt`` hold the EMA's fp32 weights, which the Predictor serves in
    the config's param dtype (bf16: the same masks as the fp32 Predictor
    up to the weights' rounding) and the Validator scores."""
    from pcmseg_tpu_torch.cli.main import main
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.train.checkpoints import load_pth
    from pcmseg_tpu_torch.train.trainer import Trainer

    whole = Trainer(_trainer_config(tree, tmp_path / "a"), device="cpu")
    history = whole.train()
    killed = _trainer_config(tree, tmp_path / "b", num_epochs=1)
    Trainer(killed, device="cpu").train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device="cpu")
    assert resumed.train() == history
    for (k, a), b in zip(whole.state.model.state_dict().items(), resumed.state.model.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for a, b in zip(whole.state.optimizer.state.values(), resumed.state.optimizer.state.values()):
        assert a["mu"].dtype == torch.bfloat16 and a["step"].dtype == torch.int32
        assert all(torch.equal(a[k], b[k]) for k in ("mu", "nu", "step"))
    for k, v in whole.state.ema.items():
        assert v.dtype == torch.float32 and torch.equal(v, resumed.state.ema[k]), k
    ckpt = torch.load(os.path.join(whole.config.save_dir, "latest.pt"), weights_only=True)
    assert {v.dtype for k, v in ckpt["model"].items() if "running" not in k and "num_batches" not in k} == {torch.bfloat16}
    sd, snapshot = load_pth(os.path.join(whole.config.save_dir, "best.pth"))
    assert snapshot["param_dtype"] == "bfloat16" and sd["inc.conv.0.weight"].dtype == torch.float32
    out = str(tmp_path / "export.pth")
    assert main(["export", "--model_path", os.path.join(whole.config.save_dir, "best.pt"), "--output", out,
                 "--device", "cpu"]) == 0
    assert {v.dtype for k, v in load_pth(out)[0].items() if "running" not in k and "num_batches" not in k} == {torch.float32}
    image = np.random.default_rng(0).normal(size=(16, 16, 16, 5)).astype(np.float32)
    low = Predictor(whole.config, out, explicit=["param_dtype"], device="cpu")
    wide = Predictor(whole.config.replace(param_dtype="float32"), out, explicit=["param_dtype"], device="cpu")
    assert {p.dtype for m in low.models for p in m.parameters()} == {torch.bfloat16}
    dp = np.abs(low.predict_probs(image) - wide.predict_probs(image))
    assert dp.max() <= 0.1 and dp.mean() <= 1e-2
    result = Validator(whole.config, out, explicit=["param_dtype"], device="cpu").validate(save=False)
    assert result["case_count"] == 5 and np.isfinite(result["avg_dice"])


def test_bf16_async_checkpoints_equal_sync_ones(tree, tmp_path):
    """The asynchronous writer snapshots bf16 parameters and moments, the
    int32 count and the fp32 EMA into its pinned buffers as they are: one
    epoch's ``latest.pt`` from the async writer holds every tensor bitwise
    equal, dtype and all, to the synchronous save's."""
    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    files = {}
    for name, async_ckpt in (("sync", False), ("async", True)):
        config = _trainer_config(tree, tmp_path / name, num_epochs=1, async_checkpoint=async_ckpt)
        Trainer(config, device="cpu").train()
        files[name] = torch.load(train_checkpoint_path(config.save_dir, "latest"), weights_only=True)

    def tensors(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (list, tuple)) else ()
        return {k: v for key, sub in items for k, v in tensors(sub, f"{prefix}/{key}").items()}

    sync, asyn = tensors(files["sync"]), tensors(files["async"])
    assert sorted(sync) == sorted(asyn)
    assert {t.dtype for t in sync.values()} >= {torch.bfloat16, torch.float32, torch.int32}
    for k, v in sync.items():
        assert v.dtype == asyn[k].dtype and torch.equal(v, asyn[k]), k


def test_bf16_cross_validation_trains_both_folds(tree, tmp_path):
    """``CrossValidationTrainer`` with bf16 params: two folds of one epoch,
    finite results, each fold's model in bf16."""
    from pcmseg_tpu_torch.train.cv import CrossValidationTrainer

    config = _trainer_config(tree, tmp_path / "cv", num_epochs=1, n_splits=2, ema_decay=0.0)
    cv = CrossValidationTrainer(config, device="cpu")
    results = cv.train()
    assert len(cv.fold_results) == 2 and all(np.isfinite(r["best_val_loss"]) for r in cv.fold_results)
    assert os.path.isfile(os.path.join(config.save_dir, "cv_results.json")) and results


# ---- parallelism with bf16 params ------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_bf16_clip_norm_is_the_whole_norm(tp):
    """The tensor-parallel clip norm of bf16 gradients on a thread group
    (``steps.sharded_global_norm``): a sharded leaf's fp32 sum of squares
    summed over the group and rounded once, the leaves added in bf16 in
    ``jax.tree.leaves``' order, as ``global_norm`` of the whole gradient
    sums them: equal to it on every rank, within one bf16 ulp (the fp32
    partial sums are added in another order; measured equal)."""
    import threading

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel.collectives import LocalGroup
    from pcmseg_tpu_torch.parallel.sharding import shard_model
    from pcmseg_tpu_torch.train.steps import global_norm, jax_order, sharded_global_norm

    base = UNet3D(base_features=4, generator=torch.Generator().manual_seed(0), param_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    for p in base.parameters():
        p.grad = (torch.randn(p.shape, generator=g) * 10.0 ** float(torch.rand((), generator=g) * -3)).to(p.dtype)
    want = float(global_norm([p.grad for p in jax_order(base)]))

    def rank(comm):
        model = copy.deepcopy(base)
        axes = shard_model(model, comm)
        for k, p in model.named_parameters():
            whole = dict(base.named_parameters())[k].grad
            a = axes[k]
            p.grad = whole if a is None else whole.narrow(a, comm.rank * p.shape[a], p.shape[a]).clone()
        return sharded_global_norm(model, jax_order(model))

    group, got = LocalGroup(tp, timeout=120), [None] * tp

    def run(r):
        try:
            got[r] = rank(group.member(r))
        except BaseException as e:
            group.abort()
            got[r] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in got:
        if isinstance(r, BaseException):
            raise r
    assert all(n.dtype == torch.bfloat16 for n in got) and len({float(n) for n in got}) == 1
    assert abs(float(got[0]) - want) <= 2.0 ** -7 * 2.0 ** np.floor(np.log2(want))


def test_jax_leaf_path_orders_the_port_parameters_as_jax_leaves():
    """``jax_leaf_path`` maps every port parameter (deep-supervision heads
    too) to its JAX path, and sorted they are ``jax.tree.leaves``' order."""
    import jax

    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import jax_leaf_path

    jmodel = JaxUNet3D.from_config(_config(deep_supervision=True))
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, np.zeros((1, 16, 16, 16, 5)),
                                                train=False))["params"]
    paths = [tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    port = UNet3D(base_features=4, deep_supervision=True, device="meta")
    names = sorted((n for n, _ in port.named_parameters()), key=jax_leaf_path)
    assert [jax_leaf_path(n) for n in names] == paths


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# mesh (data, spatial, model), accum_steps and batch size of each step on
# the gloo clusters, by cluster size: with batch 2, accum 2 on 'data' runs
# layout (b) (each data rank its own microbatch), accum 1 layout (a) (each
# microbatch over both data ranks); 4 data ranks with batch 4 in 2
# microbatches of 2 rows divide neither, layout (c) (two groups of 2 ranks,
# each group its own microbatch, a row a rank)
MESHES = {2: {"dp2": ((2, 1, 1), 2, 2), "sp2": ((1, 2, 1), 2, 2), "tp2": ((1, 1, 2), 2, 2),
              "dp2a": ((2, 1, 1), 1, 2)},
          4: {"dp2sp2": ((2, 2, 1), 2, 2), "dp4c": ((4, 1, 1), 2, 4)}}
BATCH_ROWS = 4  # the inputs' rows; a step of batch 2 takes the first 2
# the share of Adam's moments more than one ulp from one process's after the
# step (measured: dp2 0.007%, tp2 0.02%, sp2 0.03%, dp2a 0.02%, dp2sp2 0.03%, dp4c 0.025%:
# each microbatch's fp32 gradients are summed over the ranks that hold parts
# of it before the rounding to bf16, as JAX sums them; rounded on each rank
# first, sp2, dp2a and dp2sp2 read 6.4%, 5.6% and 5.3%)
MOMENT_SHARE = {"dp2": 1e-3, "sp2": 1e-3, "tp2": 1e-3, "dp2a": 1e-3, "dp2sp2": 1e-3, "dp4c": 1e-3}


def _cluster_step(given, mesh=None, rank=0, accum=2, batch=2):
    """The port's bf16-param step from ``given`` on its first ``batch`` rows
    in ``accum`` microbatches on ``mesh`` (None: one process): (its whole
    state dict, Adam's moments by name, metrics)."""
    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import shard_batch, shard_state, whole_payload
    from pcmseg_tpu_torch.train import steps

    from pcmseg_tpu_torch.models.unet3d import UNet3D

    config = _config(for_port=True, compute_dtype="float32", param_dtype="bfloat16", batch_size=batch,
                     accum_steps=accum)

    model = UNet3D.from_config(config, device="meta")
    model.load_state_dict({k: v.clone() for k, v in given["state_dict"].items()}, strict=True, assign=True)
    axes = shard_state(model, mesh) if mesh is not None else None
    state = steps.create_train_state(model, config)
    batch = {k: v[:batch] for k, v in given["batch"].items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh, rank=rank, accum=config.accum_steps)
    metrics = {k: v.detach() for k, v in steps.make_train_step(model, config, mesh=mesh)(state, batch).items()}
    names = dict(model.named_parameters())
    moments = {"model": {**{f"mu.{k}": state.optimizer.state[p]["mu"] for k, p in names.items()},
                         **{f"nu.{k}": state.optimizer.state[p]["nu"] for k, p in names.items()}}}
    sd = model.state_dict()
    if mesh is not None and mesh.model > 1:
        comm = collectives.mesh_comms(mesh).model
        sd = whole_payload({"model": sd, "optimizer": {"state": {}}}, axes, [], comm)["model"]
        mom_axes = {f"{m}.{k}": a for k, a in axes.items() for m in ("mu", "nu")}
        moments = whole_payload({"model": moments["model"], "optimizer": {"state": {}}}, mom_axes, [], comm)
    return sd, moments["model"], metrics


def _worker(pid: int, nproc: int, port: int, inputs: str, out: str) -> int:
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    given = torch.load(inputs, weights_only=True)
    results = {name: _cluster_step(given, Mesh(*mesh), pid, accum, batch)
               for name, (mesh, accum, batch) in MESHES[nproc].items()}
    torch.save(results, f"{out}.{pid}.pt")
    multihost.shutdown()
    return 0


def _cluster_states(tmp_path, nproc: int):
    """(the inputs, every rank's results of ``MESHES[nproc]``) of one gloo
    cluster of ``nproc`` processes."""
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    variables, batch = _init("bfloat16", BATCH_ROWS)
    given = {"state_dict": state_dict_from_jax_params(variables["params"], variables["batch_stats"]),
             "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out")
    torch.save(given, inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(nproc), str(port), inputs, out], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return given, [torch.load(f"{out}.{r}.pt", weights_only=True) for r in range(nproc)]


def _check_clusters(given, ranks, nproc: int, names=None) -> None:
    """Each of ``names`` (all of ``MESHES[nproc]`` by default) against the
    same step in one process."""
    refs = {}
    for name, (_, accum, batch) in MESHES[nproc].items():
        if names is not None and name not in names:
            continue
        if (accum, batch) not in refs:
            refs[accum, batch] = _cluster_step(given, accum=accum, batch=batch)
        ref_sd, ref_mom, ref_metrics = refs[accum, batch]
        sd0, mom0, m0 = ranks[0][name]
        for sd, _, m in (r[name] for r in ranks[1:]):
            for k in sd0:
                assert torch.equal(sd0[k], sd[k]), (name, k)
            assert float(m0["loss"]) == float(m["loss"]) and float(m0["grad_norm"]) == float(m["grad_norm"])
        np.testing.assert_allclose(float(m0["loss"]), float(ref_metrics["loss"]), rtol=1e-5, err_msg=name)
        assert m0["grad_norm"].dtype == torch.bfloat16
        assert int(ulps(m0["grad_norm"].reshape(1), ref_metrics["grad_norm"].reshape(1)).max()) <= 1, name
        for k, v in ref_sd.items():
            if "running" in k:
                assert sd0[k].dtype == torch.float32 and float((sd0[k] - v).abs().max()) <= 1e-5, (name, k)
            elif v.is_floating_point() and not BN_PRECEDED_BIAS.search(k):
                assert sd0[k].dtype == torch.bfloat16 and int(ulps(sd0[k], v).max()) <= 1, (name, k)
        d = torch.cat([ulps(mom0[k], v).reshape(-1) for k, v in ref_mom.items() if not BN_PRECEDED_BIAS.search(k)])
        assert int((d > 1).sum()) <= MOMENT_SHARE[name] * d.numel(), (name, int((d > 1).sum()), d.numel())


def test_bf16_params_on_dp_sp_tp_clusters_match_one_process(tmp_path):
    """One bf16-param step (fp32 compute, batch 2, 32³) on gloo clusters of
    2 processes, a data, a spatial and a model axis of 2 (2 microbatches),
    and a data axis with 1 microbatch over both ranks, against the same step
    in one process: the loss within 1e-5 and the clip norm in bf16 within
    one ulp, every parameter and Adam moment bf16 and within one bf16 ulp
    (on the data axis each rank's bf16 gradients of its own microbatch are
    summed over the ranks in fp32 and rounded again, where one process
    accumulates its microbatches in bf16: the roundings meet at other
    points; where a microbatch spans ranks, slabs or rows, its fp32
    gradients are summed over them before their one rounding, as one
    process rounds them), Adam's moments beyond one ulp on at most
    ``MOMENT_SHARE`` of the elements, the running statistics within 1e-5,
    and both ranks' states bitwise equal."""
    given, ranks = _cluster_states(tmp_path, 2)
    _check_clusters(given, ranks, 2)


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    """One gloo cluster of 4 processes running ``MESHES[4]``."""
    return _cluster_states(tmp_path_factory.mktemp("cluster4"), 4)


def test_bf16_params_on_a_data_by_spatial_cluster_match_one_process(cluster4):
    """The same on a 2 × 2 data × spatial mesh of 4 processes, 2
    microbatches (layout (b)): each microbatch's fp32 gradients are summed
    over its two slabs and rounded, then the data ranks' bf16 sums are
    summed in fp32 and rounded again; every rank's state bitwise equal."""
    _check_clusters(*cluster4, 4, ["dp2sp2"])


def test_bf16_params_in_layout_c_match_one_process(cluster4):
    """The same on 4 data ranks with batch 4 in 2 microbatches (layout (c),
    ``sharding.microbatch_layout``): two groups of q = 2 ranks, each group
    one microbatch, one row a rank; each microbatch's fp32 gradients are
    summed over its group before their one rounding to bf16 and the groups'
    bf16 sums over the data ranks in fp32 (``train/steps.py``), against one
    process's step of the same 4 rows in 2 microbatches; every rank's state
    bitwise equal."""
    _check_clusters(*cluster4, 4, ["dp4c"])


# ---- the kernels' dtype dispatch and the dtypes refused by name -----------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mixed_dtype_pairs_are_refused_on_every_device(device):
    """x and the packed weight (B1), x and dy (B2), share one dtype on
    every device: a mixed pair raises ``TypeError`` before any dispatch."""
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    x = torch.zeros(1, 4, 4, 4, 8, device=device)
    packed = torch.zeros(8, conv3d.packed_k(8), device=device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share a dtype"):
        conv3d.conv3x3x3(x, packed)
    with pytest.raises(TypeError, match="share a dtype"):
        conv3d_grad.conv3x3_dw(x, x.to(torch.bfloat16))


def test_fp32_and_bf16_cpu_tensors_run_the_plain_versions():
    """An fp32 (or bf16) CPU tensor runs the plain version: neither kernel's
    count moves, and the result is the reference's in x's dtype."""
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, 5, 6, 7, 16, generator=g).to(dtype)
        packed = conv3d.pack_weight(torch.randn(8, 16, 3, 3, 3, generator=g), dtype)
        b = torch.randn(8, generator=g).to(dtype)  # a 16-bit bias parameter, added in fp32
        before = (conv3d.launches, conv3d.launches_f32, conv3d_grad.launches, conv3d_grad.launches_f32)
        y = conv3d.conv3x3x3(x, packed, b, True)
        dw = conv3d_grad.conv3x3_dw(x, y)
        assert (conv3d.launches, conv3d.launches_f32, conv3d_grad.launches, conv3d_grad.launches_f32) == before
        assert y.dtype == dtype and torch.equal(y, conv3d.conv3x3x3_reference(x, packed, b, True))
        assert dw.dtype == torch.float32 and torch.equal(dw, conv3d_grad.conv3x3_dw_reference(x, y))


@pytest.mark.parametrize("name", ["float16", "float64"])
def test_compute_dtypes_the_kernels_do_not_take_are_refused_by_name(name, tree, tmp_path):
    """JAX computes in any dtype ``jnp.dtype`` names; the port's kernels in
    bf16, fp16 and fp32. fp16 compute builds where a model, a Trainer, a
    Validator or a Predictor is built (tests/test_torch_fp16.py holds it
    against JAX); another compute dtype is refused there by name with
    ``NotImplementedError``, and so is a param dtype outside fp32, bf16
    and fp16."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import save_pth
    from pcmseg_tpu_torch.train.trainer import Trainer

    pth = save_pth(str(tmp_path / "m.pth"), UNet3D(base_features=4).state_dict(), {"base_features": 4})
    config = _trainer_config(tree, tmp_path / "v", compute_dtype=name)
    builds = [
        lambda: UNet3D.from_config(get_config(base_features=4, compute_dtype=name), device="meta").dtype,
        lambda: Trainer(_trainer_config(tree, tmp_path / "t", compute_dtype=name), device="cpu").dtype,
        lambda: Predictor(config, pth, explicit=["compute_dtype"], device="cpu").dtype,
        lambda: Validator(config, pth, explicit=["compute_dtype"], device="cpu").dtype,
    ]
    for build in builds:
        if name == "float16":
            assert build() == torch.float16
            continue
        with pytest.raises(NotImplementedError, match=f"compute_dtype='{name}'"):
            build()
    if name == "float64":
        with pytest.raises(NotImplementedError, match="param_dtype='float64'"):
            UNet3D.from_config(get_config(base_features=4, param_dtype=name), device="meta")


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
