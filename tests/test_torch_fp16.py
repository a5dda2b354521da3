"""fp16 compute (``compute_dtype='float16'``), the port against the JAX
package on the CPU.

The kernels' plain versions on fp16 operands (the wrappers on CPU tensors):
B1's forward and dx against JAX's Pallas ``conv3x3x3`` in interpret mode,
within 2^-10 of the largest output (one fp16 ulp at it: both round an fp32
sum once, summed in other orders); B2 against JAX's Pallas
``conv3x3_dw`` in interpret mode and a float64 sum, within 1e-5 of the
largest entry (products of fp16 values are exact in fp32, only the order
of the fp32 sums differs). JAX's ``conv3x3_dw_reference`` is not used: it
raises on 16-bit inputs (ROADMAP queue C).

The folded serving forward: the port's fp16 ``Predictor`` and JAX's on one
JAX-exported ``.pth`` (base 4), the port no further from JAX's fp16
probabilities than 1.5 times JAX's fp16 is from its fp32, plus 1e-3.

The train step from the same JAX-initialised weights on the same seeded
batch (base 4, 32³, batch 2, Adam eps 1e-2, weight decay 1e-2, lr 1e-3, as
``tests/test_torch_param_dtype.py``), fp16 compute with fp32, bf16 and fp16
parameters, 2 steps: the loss within 2^-10 of JAX's fp16 step; the grad
norm, Adam's moments, the parameters' changes and the running statistics
no further from JAX's fp32-compute step from the same weights than
MARGIN times JAX's fp16 step is (ROADMAP C4: the frameworks round fp16 at
other places, JAX adding a conv's bias in fp16 after the conv, the port in
fp32 in B1's epilogue, so the port is held to fp32, not to JAX's roundings).
Measured after steps 1 and 2 (the port / JAX's fp16, each from JAX's fp32
step), fp32 params: grad norm 7.8e-4 / 1.4e-3 and 5.4e-4 / 2.7e-3, the
parameters' changes 0.029 / 0.074 and 0.022 / 0.068, mu 0.027 / 0.077, nu
0.020 / 0.065, running statistics 2.4e-4 / 2.6e-4 and 2.6e-4 / 5.3e-4; bf16
params: changes 0.29 / 0.42, statistics 2.3e-4 / 2.0e-4 after step 1; fp16
params: changes 0.10 / 0.12, statistics 1.6e-4 / 1.5e-4 after step 1 (the
statistics after step 1 come from the first forward alone, where the two
frameworks' fp16 roundings are alike).

Meshes: one 2-process gloo cluster (the workers are this file: ``python
tests/test_torch_fp16.py PID NPROC PORT INPUTS OUT``) runs the fp16 step on
a spatial-2 and on a model-2 mesh; each is held against the port's
one-process fp16 step (loss within 2^-10) and, as above, no further from
the one-process fp32-compute step than MARGIN times the one-process fp16
step is; every rank's (gathered) state bitwise equal.
"""

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
STEPS = 2
LR = 1e-3
BN_PRECEDED_BIAS = re.compile(r"conv\.[03]\.bias$")
EPS_F16 = 2.0 ** -10  # one fp16 ulp at 1.0
MARGIN = 1.5  # the C4 rule: no further from fp32 than MARGIN times JAX's own fp16
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7, "float16": EPS_F16}
PARAM_DTYPES = ("float32", "bfloat16", "float16")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float16)


# ---- the kernels' plain versions -------------------------------------------------------


@pytest.mark.parametrize("n,spatial,ci,co", [(1, (4, 6, 8), 5, 8), (2, (5, 4, 6), 8, 16), (1, (6, 6, 6), 16, 24)])
def test_b1_forward_and_dx_match_pallas_interpret(n, spatial, ci, co):
    import jax.numpy as jnp

    from pcmseg_tpu.ops.pallas.conv3d import conv3x3x3 as jax_conv
    from pcmseg_tpu_torch.ops.kernels import conv3d

    x = _rand((n, *spatial, ci), ci)
    w = _rand((3, 3, 3, ci, co), co, (2.0 / (27 * ci)) ** 0.5)  # flax layout
    b = np.random.default_rng(7).normal(0, 0.1, co).astype(np.float32)
    dy = _rand((n, *spatial, co), co + 1)
    weight = torch.from_numpy(w).permute(4, 3, 0, 1, 2)  # (Co, Ci, 3, 3, 3)
    cases = {
        "forward": (x, w, b, True, weight),
        # dx: the same kernel on dy with the flipped, Ci<->Co-transposed weight
        "dx": (dy, np.ascontiguousarray(w[::-1, ::-1, ::-1].swapaxes(3, 4)), None, False,
               weight.flip(2, 3, 4).transpose(0, 1)),
    }
    for name, (inp, jw, jb, relu, tw) in cases.items():
        want = np.asarray(jax_conv(jnp.asarray(inp), jnp.asarray(jw), None if jb is None else jnp.asarray(jb),
                                   relu=relu, interpret=True)).astype(np.float32)
        got = conv3d.conv3x3x3(torch.from_numpy(inp), conv3d.pack_weight(tw, torch.float16),
                               None if jb is None else torch.from_numpy(jb), relu)
        assert got.dtype == torch.float16 and tuple(got.shape) == want.shape, name
        err = np.abs(got.float().numpy() - want).max()
        assert err <= EPS_F16 * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.parametrize("n,spatial,ci,co", [(1, (4, 6, 8), 5, 8), (2, (5, 4, 6), 8, 16), (1, (6, 6, 6), 16, 24)])
def test_b2_matches_pallas_interpret_and_float64(n, spatial, ci, co):
    import jax.numpy as jnp

    from pcmseg_tpu.ops.pallas.conv3d_grad import conv3x3_dw as jax_dw
    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    x, dy = _rand((n, *spatial, ci), ci), _rand((n, *spatial, co), co + 100)
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy), interpret=True))
    exact = conv3d_grad.conv3x3_dw_reference(torch.from_numpy(x).double(), torch.from_numpy(dy).double()).numpy()
    got = conv3d_grad.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and want.dtype == np.float32 and tuple(got.shape) == (3, 3, 3, ci, co)
    scale = np.abs(exact).max()
    assert np.abs(want - exact).max() <= 1e-5 * scale  # the Pallas kernel itself
    for ref in (want, exact):
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale


# ---- the folded serving forward ---------------------------------------------------------


def test_predictor_matches_jax_fp16_predict(tmp_path):
    """The port's fp16 Predictor serves the folded model from an fp32 stack
    (JAX's wire dtype for fp16 compute); its probabilities lie no further
    from JAX's fp16 ones than 1.5 times JAX's fp16 lies from its fp32, plus
    1e-3."""
    import jax

    from pcmseg_tpu.core.config import get_config as jax_get_config
    from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.train.checkpoints import export_torch_checkpoint
    from pcmseg_tpu.train.steps import create_train_state
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor

    kw = dict(base_features=4, remat=False, target_size=(16, 16, 16))
    jax_config = jax_get_config("quick", compute_dtype="float32", **kw)
    state = create_train_state(jax_config, jax.random.key(0), JaxUNet3D.from_config(jax_config), (1, 16, 16, 16, 5))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, size=a.shape) if str(path[-1]) == "['var']"
                         else rng.normal(0.0, 0.1, size=a.shape)).astype(np.float32),
        jax.device_get(state.batch_stats))
    pth = str(tmp_path / "model.pth")
    export_torch_checkpoint(pth, state.replace(batch_stats=stats), meta={"config": jax_config.to_dict()})
    image = rng.normal(size=(16, 16, 16, 5)).astype(np.float32)

    want32 = JaxPredictor(jax_config, pth).predict_probs(image)
    want16 = JaxPredictor(jax_get_config("quick", compute_dtype="float16", **kw), pth).predict_probs(image)
    port = Predictor(get_config("quick", compute_dtype="float16", **kw), pth, explicit=["compute_dtype"],
                     device="cpu")
    assert port.dtype == torch.float16 and port.wire_dtype == torch.float32
    assert {m.dtype for m in port.models} == {torch.float16}
    got = port.predict_probs(image)
    assert got.dtype == np.float32 and got.shape == want16.shape and np.isfinite(got).all()
    own = np.abs(want16 - want32).max()
    assert np.abs(got - want16).max() <= MARGIN * own + 1e-3, (np.abs(got - want16).max(), own)


# ---- the train step ---------------------------------------------------------------------


def _config(for_port=False, **kw):
    """The JAX package's config (the port's with ``for_port=True``)."""
    if for_port:
        from pcmseg_tpu_torch.core.config import get_config
    else:
        from pcmseg_tpu.core.config import get_config

    kw = dict(dict(eps=1e-2, weight_decay=1e-2, batch_size=2, learning_rate=LR, target_size=(SIZE,) * 3), **kw)
    return get_config(base_features=4, remat=False, conv_lowering="lax", **kw)


def _init(param_dtype: str):
    """JAX-initialised variables (numpy, params in ``param_dtype``) with
    non-trivial 1-D params, and a train batch of 2."""
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
    image = rng.normal(size=(2, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(2)])[..., None]
    return variables, {"image": image, "label": label}


def _sd(params, stats=None):
    import jax

    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    return state_dict_from_jax_params(jax.device_get(params), stats and jax.device_get(stats))


def _jax_run(config, variables, batch):
    """[{params, stats, mu, nu, loss, grad_norm}] after each step of JAX's step."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.train import steps as jax_steps

    model = JaxUNet3D.from_config(config)
    state = jax_steps.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), ema_params={},
        tx=jax_steps.make_optimizer(config),
    )
    step, out = jax.jit(jax_steps.make_train_step(model, config)), []
    for _ in range(STEPS):
        state, m = step(state, batch)
        adam = state.opt_state.inner_state[-3]
        out.append(dict(params=_sd(state.params), stats=_sd(state.params, state.batch_stats), mu=_sd(adam.mu),
                        nu=_sd(adam.nu), loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    return out


def _port_model(config, state_dict):
    from pcmseg_tpu_torch.models.unet3d import UNet3D

    model = UNet3D.from_config(config, device="meta")
    model.load_state_dict({k: v.clone() for k, v in state_dict.items()}, strict=True, assign=True)
    return model


def _records(model, state, metrics):
    names = dict(model.named_parameters())
    opt = {p: {k.replace("exp_avg_sq", "nu").replace("exp_avg", "mu"): v for k, v in s.items()}
           for p, s in state.optimizer.state.items()}
    return dict(params={k: p.detach().clone() for k, p in names.items()},
                stats={k: v.clone() for k, v in model.state_dict().items()},
                mu={k: opt[p]["mu"].clone() for k, p in names.items()},
                nu={k: opt[p]["nu"].clone() for k, p in names.items()},
                loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))


def _port_run(config, state_dict, batch, steps=STEPS):
    from pcmseg_tpu_torch.train import steps as port_steps

    model = _port_model(config, state_dict)
    state = port_steps.create_train_state(model, config)
    step = port_steps.make_train_step(model, config)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return [_records(model, state, step(state, tbatch)) for _ in range(steps)]


def _distance(got, want, base=None):
    """‖got − want‖ / ‖want‖ in float64 over the leaves but the BN-preceded
    conv biases (rounding noise: their true gradient is 0), of the changes
    from ``base`` where given."""
    num = den = 0.0
    for k in want:
        if BN_PRECEDED_BIAS.search(k):
            continue
        a, b = got[k].double(), want[k].double()
        if base is not None:
            a, b = a - base[k].double(), b - base[k].double()
        num, den = num + float(((a - b) ** 2).sum()), den + float((b ** 2).sum())
    return (num / den) ** 0.5


def _stats_far(got, want):
    keys = [k for k in want if "running" in k]
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in keys)


def _hold_to_fp32(port, theirs, exact, base, param_dtype, label, leaves=("params", "mu", "nu")):
    """The C4 rule after each step: the port's (``port``) grad norm, moments,
    parameter changes and running statistics no further from the fp32-compute
    step (``exact``) than MARGIN times ``theirs`` (the fp16 step it is held
    beside) is (of the moments where ``leaves`` names them)."""
    for i, (got, want, ref) in enumerate(zip(port, theirs, exact)):
        ulp = ULP[param_dtype] * 2.0 ** np.floor(np.log2(ref["grad_norm"]))
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= MARGIN * abs(want["grad_norm"] - ref["grad_norm"]) + ulp, (
            label, i, got["grad_norm"], want["grad_norm"], ref["grad_norm"])
        for what in leaves:
            origin = base if what == "params" else None
            mine, their = _distance(got[what], ref[what], origin), _distance(want[what], ref[what], origin)
            assert mine <= MARGIN * their, (label, i, what, mine, their)
        mine, their = _stats_far(got["stats"], ref["stats"]), _stats_far(want["stats"], ref["stats"])
        assert mine <= MARGIN * their + 1e-6, (label, i, "running statistics", mine, their)


@pytest.fixture(scope="module", params=PARAM_DTYPES)
def stepped(request):
    """(param dtype, JAX's fp16 records, JAX's fp32-compute records, the
    port's fp16 records, the initial params) of each of STEPS steps."""
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    variables, batch = _init(request.param)
    kw = dict(compute_dtype="float16", param_dtype=request.param)
    jax16 = _jax_run(_config(**kw), variables, batch)
    jax32 = _jax_run(_config(**dict(kw, compute_dtype="float32")), variables, batch)
    sd = state_dict_from_jax_params(variables["params"], variables["batch_stats"])
    port = _port_run(_config(for_port=True, **kw), sd, batch)
    return request.param, jax16, jax32, port, _sd(variables["params"])


def test_fp16_step_loss_matches_jax(stepped):
    """After each step the loss within 2^-10 of JAX's fp16 step's; the
    parameters, moments and running statistics keep their dtypes (the
    param dtype; fp32 statistics)."""
    param_dtype, jax16, _, port, _ = stepped
    dtype = getattr(torch, param_dtype)
    for i, (got, want) in enumerate(zip(port, jax16)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=EPS_F16, err_msg=f"step {i + 1}")
        for what in ("params", "mu", "nu"):
            assert {t.dtype for t in got[what].values()} == {dtype}, what
        assert {v.dtype for k, v in got["stats"].items() if "running" in k} == {torch.float32}
        assert all(bool(torch.isfinite(t).all()) for t in got["params"].values())


def test_fp16_step_is_as_near_fp32_as_jax(stepped):
    """The grad norm, Adam's moments, the parameters' changes and the
    running statistics after each step no further from JAX's fp32-compute
    step than MARGIN times JAX's fp16 step is (plus one ulp of the norm's
    dtype, 1e-6 for the statistics)."""
    param_dtype, jax16, jax32, port, base = stepped
    _hold_to_fp32(port, jax16, jax32, base, param_dtype, param_dtype)


# ---- meshes ---------------------------------------------------------------------------------

# mesh (data, spatial, model) of each fp16 step on the 2-process cluster
MESHES = {"sp2": (1, 2, 1), "tp2": (1, 1, 2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cluster_step(given, mesh, rank):
    """The fp16 step from ``given`` on ``mesh``: (its whole state dict, metrics)."""
    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import shard_batch, shard_state, whole_payload
    from pcmseg_tpu_torch.train import steps

    config = _config(for_port=True, compute_dtype="float16", spatial_parallel=mesh.spatial,
                     tensor_parallel=mesh.model)
    model = _port_model(config, given["state_dict"])
    axes = shard_state(model, mesh)
    state = steps.create_train_state(model, config)
    batch = shard_batch(given["batch"], mesh, rank=rank, accum=1)
    metrics = {k: v.detach() for k, v in steps.make_train_step(model, config, mesh=mesh)(state, batch).items()}
    sd = model.state_dict()
    if mesh.model > 1:
        sd = whole_payload({"model": sd, "optimizer": {"state": {}}}, axes, [], collectives.mesh_comms(mesh).model)[
            "model"]
    return sd, metrics


def _worker(pid: int, nproc: int, port: int, inputs: str, out: str) -> int:
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    given = torch.load(inputs, weights_only=True)
    results = {name: _cluster_step(given, Mesh(*mesh), pid) for name, mesh in MESHES.items()}
    torch.save(results, f"{out}.{pid}.pt")
    multihost.shutdown()
    return 0


def test_fp16_step_on_spatial_and_model_meshes_matches_one_process(tmp_path):
    """One fp16 step (fp32 params) on a spatial-2 and a model-2 mesh of 2
    gloo processes: every rank's (gathered) state and metrics bitwise equal;
    the loss within 2^-10 of one process's fp16 step; the grad norm, the
    parameters' changes and the running statistics no further from one
    process's fp32-compute step than MARGIN times one process's fp16 step
    is (the ranks sum BatchNorm's statistics, and on the model axis a
    layer's input gradient, in another order, which fp16 roundings carry)."""
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    variables, batch = _init("float32")
    given = {"state_dict": state_dict_from_jax_params(variables["params"], variables["batch_stats"]),
             "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out")
    torch.save(given, inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), inputs, out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        one16 = _port_run(_config(for_port=True, compute_dtype="float16"), given["state_dict"], batch, 1)
        one32 = _port_run(_config(for_port=True, compute_dtype="float32"), given["state_dict"], batch, 1)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=True) for r in range(2)]
    base = {k: v for k, v in given["state_dict"].items() if k in one16[0]["params"]}
    for name in MESHES:
        (sd0, m0), (sd1, m1) = ranks[0][name], ranks[1][name]
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), name
        assert float(m0["loss"]) == float(m1["loss"]) and float(m0["grad_norm"]) == float(m1["grad_norm"]), name
        np.testing.assert_allclose(float(m0["loss"]), one16[0]["loss"], rtol=EPS_F16, err_msg=name)
        got = dict(params={k: sd0[k] for k in base}, stats=sd0, grad_norm=float(m0["grad_norm"]))
        _hold_to_fp32([got], one16, one32, base, "float32", name, leaves=("params",))


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
