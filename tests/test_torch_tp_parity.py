"""The port's tensor-parallel train and eval steps against the JAX
package's and against its own one-process step, on the CPU.

Gloo clusters whose workers are this file itself, started by
``subprocess`` (``python tests/test_torch_tp_parity.py PID NPROC PORT
INPUTS OUT``, each with a timeout): 2 processes on a data 1 × spatial 1 ×
model 2 mesh, 4 on (1, 1, 4), (2, 1, 2) and (1, 2, 2), 8 on (2, 2, 2).
Each rank builds the model whole from the same JAX-initialised weights
(crossed through ``state_dict_from_jax_params``), keeps its output-channel
shards (``sharding.shard_state``), takes its rows and D-slab of the global
batch (``sharding.shard_batch``: the same on every rank of a model group)
and runs ``make_train_step`` once; the shards are then gathered back to
the whole state on every rank (``sharding.whole_payload``). float32, base
4, 32³, Adam eps 1e-2, lr 1e-3.

Where JAX's own gradient is sound the port is held to JAX: on
``make_mesh(1, 1, 2)`` (params and BN statistics placed by ``param_spec``)
JAX's gradient lies within 3.2e-6 / 9.0e-6 of its one-device gradient
(conv kernels / BN scales, each leaf's largest difference over its largest
entry); on (1, 1, 4) within 8.6e-4 / 7.1e-4, on (2, 1, 2) 0.030 / 0.027, on
(1, 2, 2) 0.031 / 0.019 and on (2, 2, 2) 0.50 / 0.018, with a grad norm of
0.07444 against 0.07610 on one device (``python tools/jax_spatial_grads.py
--model``). So BatchNorm in layout (a) and a K = 3 GroupNorm model on
(1, 1, 2) are held to JAX's step there: loss, grad norm, state, and the eval
step's metrics. On every other mesh the port's step is held to the port's
own one-process step (no process group, the whole batch) and to JAX's loss
on that mesh, which is sound everywhere, never to JAX's gradients:
BatchNorm (a) on (1, 1, 4) and (2, 2, 2), BatchNorm in layout (b) (batch 4
in 4 microbatches, each data rank 2 of them) on (2, 1, 2), a
deep-supervision model on (1, 2, 2) (D-slabs with conv halos under the
channel shards). Two more against one process only: base 6 on (1, 1, 4),
whose 6-channel level 1 and ``up4``'s transposed conv run replicated
between sharded levels 2-5; GroupNorm with one group (``group_norm_groups
= 1``) on (1, 1, 2), whose group spans both shards.

Tolerances, ``tests/test_torch_dp_parity.py``'s: the loss to rtol 1e-5,
the pre-clip grad norm to rtol 2e-4, every parameter and running statistic
to atol 2e-5, the biases that the norm after them cancels (true gradient
0) to 2·lr; the eval step's loss to rtol 1e-5 and Dice/IoU to atol 1e-4.
Every rank of a cluster holds the same gathered state and the same
metrics, bit for bit.
"""

import os
import re
import socket
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
LR = 1e-3
ATOL = 2e-5
CONV_BIAS = re.compile(r"conv\.[03]\.bias$")
# name -> (data, spatial, model) mesh, what holds it, and the config's differences
VARIANTS = {
    "m112_bn_a": dict(mesh=(1, 1, 2), held="jax", batch_size=2),
    "m112_k3_group": dict(mesh=(1, 1, 2), held="jax", batch_size=2, n_classes=3, norm_layer="group",
                          loss="bce_dice"),
    "m112_group_spans": dict(mesh=(1, 1, 2), held="one", batch_size=2, norm_layer="group", group_norm_groups=1),
    "m114_bn_a": dict(mesh=(1, 1, 4), held="one", batch_size=2),
    "m114_base6": dict(mesh=(1, 1, 4), held="one", batch_size=2, base_features=6),
    "m212_bn_b": dict(mesh=(2, 1, 2), held="one", batch_size=4, accum_steps=4),
    "m122_ds": dict(mesh=(1, 2, 2), held="one", batch_size=2, deep_supervision=True),
    "m222_bn_a": dict(mesh=(2, 2, 2), held="one", batch_size=4),
}
EVALS = ("m112_bn_a", "m112_k3_group")
# the variants whose loss is also held to JAX's on their mesh
JAX_LOSS = ("m114_bn_a", "m212_bn_b", "m122_ds", "m222_bn_a")


def _kwargs(variant):
    kw = {k: v for k, v in VARIANTS[variant].items() if k not in ("mesh", "held")}
    kw.setdefault("base_features", 4)
    return dict(remat=False, compute_dtype="float32", target_size=(SIZE,) * 3, learning_rate=LR, eps=1e-2,
                weight_decay=1e-2, **kw)


def _arch(variant):
    kw = _kwargs(variant)
    return (kw.get("n_classes", 1), kw.get("norm_layer", "batch"), kw.get("deep_supervision", False),
            kw["base_features"], kw.get("group_norm_groups", 8))


def _init(variant, rng):
    """JAX-initialised variables (numpy) of the variant's model with every
    1-D parameter moved off its init."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D.from_config(get_config(conv_lowering="lax", **_kwargs(variant)))
    variables = jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False)
    )(jax.random.key(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).startswith("['params']") and a.ndim == 1
        else np.asarray(a),
        jax.device_get(variables),
    )


def _batch(n, n_classes, rng):
    z, y, x = np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij")
    blob = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 80).astype(np.float32)
    image = rng.normal(size=(n, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    # samples of other intensities: the microbatches' BatchNorm statistics differ
    image *= np.float32(1.0) + np.float32(0.5) * np.arange(n, dtype=np.float32)[:, None, None, None, None]
    label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(n)])[..., None]
    if n_classes == 3:
        core = (z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 20
        label = (label + np.stack([np.roll(core, 3 * i, axis=1) for i in range(n)])[..., None]).astype(np.int32)
    return {"image": image, "label": label}


def _cancelled_bias(name, state_dict, groups):
    """Whether the norm after conv ``name`` takes its bias out: BatchNorm,
    or GroupNorm with one channel per group."""
    if not CONV_BIAS.search(name):
        return False
    norm = name.rsplit(".", 2)[0] + "." + str(int(name.rsplit(".", 2)[1]) + 1)
    if norm + ".running_mean" in state_dict:
        return True
    channels = state_dict[norm + ".weight"].numel()
    return min(groups, channels) == channels


def _port_step(variant, data, mesh=None, rank=0):
    """(the model after one step, its metrics[, the eval metrics]) of the
    port's step on ``mesh`` (None: one process, no group)."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel.sharding import shard_batch, shard_state
    from pcmseg_tpu_torch.train import steps

    config = get_config(**_kwargs(variant))
    model = UNet3D.from_config(config, deep_supervision=config.deep_supervision, device="meta")
    model.load_state_dict({k: v.clone() for k, v in data["state_dict"].items()}, strict=True, assign=True)
    axes = shard_state(model, mesh) if mesh is not None else None
    out = {}

    def local(batch, accum=1):
        return shard_batch(batch, mesh, rank=rank, accum=accum) if mesh is not None else batch

    if variant in EVALS:
        evaluate = steps.make_eval_step(model, config, mesh=mesh)
        out["eval"] = dict(evaluate(steps.TrainState(model=model, optimizer=None),
                                    local(dict(data["batch"], weight=data["eval_weight"]))))
    state = steps.create_train_state(model, config)
    metrics = steps.make_train_step(model, config, mesh=mesh)(state, local(data["batch"], config.accum_steps))
    out.update({k: v.detach() for k, v in metrics.items()})
    return model, axes, out


def _worker(pid: int, nproc: int, port: int, inputs: str, out: str) -> int:
    import torch

    from pcmseg_tpu_torch.parallel import collectives, multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, whole_payload

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    given = torch.load(inputs, weights_only=True)
    results = {}
    for variant, data in given.items():
        mesh = Mesh(*VARIANTS[variant]["mesh"])
        model, axes, got = _port_step(variant, data, mesh, pid)
        comm = collectives.mesh_comms(mesh).model
        whole = whole_payload({"model": model.state_dict(), "optimizer": {"state": {}}}, axes, [], comm)
        got["state_dict"] = whole["model"]
        got["local_shapes"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        results[variant] = got
    torch.save(results, f"{out}.{pid}.pt")
    multihost.shutdown()
    return 0


def _jax_results(variant, variables, batch, eval_weight):
    """JAX's eval metrics (on EVALS) and (state dict, metrics) after one
    train step on the variant's mesh."""
    import jax

    from pcmseg_tpu.parallel.sharding import make_mesh, shard_batch
    from pcmseg_tpu.train import steps as jax_steps
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.parallel.sharding import shard_state
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    dp, sp, tp = VARIANTS[variant]["mesh"]
    mesh = make_mesh(dp, sp, tp, devices=jax.devices()[: dp * sp * tp])
    config = get_config(conv_lowering="lax", **_kwargs(variant))
    model = JaxUNet3D.from_config(config)
    state = shard_state(jax_steps.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})), ema_params={},
        tx=jax_steps.make_optimizer(config),
    ), mesh)
    out = {}
    if variant in EVALS:
        got = jax.jit(jax_steps.make_eval_step(model, config))(state, shard_batch(dict(batch, weight=eval_weight),
                                                                                  mesh))
        out["eval"] = {k: np.asarray(v) for k, v in got.items()}
    state, metrics = jax.jit(jax_steps.make_train_step(model, config))(state, shard_batch(batch, mesh))
    stats = jax.device_get(state.batch_stats) if state.batch_stats else None
    out.update(state_dict=state_dict_from_jax_params(jax.device_get(state.params), stats),
               metrics={k: float(v) for k, v in metrics.items()})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(nproc, inputs, out):
    import subprocess

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(nproc), str(port), inputs, out],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(nproc)]


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Per variant: (JAX's results or None, every rank's results, one
    process's results, the inputs)."""
    import torch

    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    tmp = tmp_path_factory.mktemp("tp_parity")
    rng = np.random.default_rng(3)
    inits, inputs, by_size = {}, {}, {}
    for variant, kw in VARIANTS.items():
        arch = _arch(variant)
        if arch not in inits:
            inits[arch] = _init(variant, rng)
        variables = inits[arch]
        inputs[variant] = {
            "state_dict": state_dict_from_jax_params(variables["params"], variables.get("batch_stats")),
            "batch": {k: torch.from_numpy(v) for k, v in _batch(kw["batch_size"], arch[0], rng).items()},
            "eval_weight": torch.ones(kw["batch_size"]).index_fill_(0, torch.tensor([1]), 0.0),
        }
        by_size.setdefault(int(np.prod(kw["mesh"])), {})[variant] = inputs[variant]
    procs = {}
    for n, given in by_size.items():
        torch.save(given, str(tmp / f"inputs{n}.pt"))
        procs[n] = _spawn(n, str(tmp / f"inputs{n}.pt"), str(tmp / f"out{n}"))
    try:
        # JAX's steps and the port's one-process steps run while the clusters work
        want, one = {}, {}
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for variant in VARIANTS:
                model, _, got = _port_step(variant, inputs[variant])
                one[variant] = dict(got, state_dict=model.state_dict())
        finally:
            torch.set_num_threads(prev)
        for variant, kw in VARIANTS.items():
            if kw["held"] == "jax" or variant in JAX_LOSS:
                batch = {k: v.numpy() for k, v in inputs[variant]["batch"].items()}
                want[variant] = _jax_results(variant, inits[_arch(variant)], batch,
                                             inputs[variant]["eval_weight"].numpy())
        outs = {n: [p.communicate(timeout=420)[0] for p in ps] for n, ps in procs.items()}
    finally:
        for p in sum(procs.values(), []):
            if p.poll() is None:
                p.kill()
                p.communicate()
    for n, ps in procs.items():
        for p, o in zip(ps, outs[n]):
            assert p.returncode == 0, o[-4000:]
    ranks = {n: [torch.load(str(tmp / f"out{n}.{pid}.pt"), weights_only=True) for pid in range(n)] for n in procs}
    return {v: (want.get(v), [r[v] for r in ranks[int(np.prod(kw["mesh"]))]], one[v], inputs[v])
            for v, kw in VARIANTS.items()}


def _hold_state(variant, got, expect, init, accum):
    got, expect = dict(got), dict(expect)
    groups = _kwargs(variant).get("group_norm_groups", 8)
    for k in [k for k in got if k.endswith("num_batches_tracked")]:
        assert int(got.pop(k)) == accum
        expect.pop(k)
    assert sorted(got) == sorted(expect)
    for k, w in expect.items():
        g, w = got[k].numpy(), w.numpy()
        if _cancelled_bias(k, got, groups):
            assert np.abs(g - w).max() <= 2 * LR, f"{variant} {k}"
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{variant} {k}")
        if w.ndim > 1 or "running" in k:
            assert np.abs(w - init[k].numpy()).max() >= 5 * ATOL, f"{variant} {k} barely moved"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ranks_hold_bitwise_equal_states(stepped, variant):
    """Every rank's gathered state and metrics are the same, bit for bit;
    each rank held its shards of the sharded leaves (a leaf the model
    group's size divides, JAX's rule by shape) and the replicated ones whole."""
    import torch

    _, ranks, one, _ = stepped[variant]
    tp = VARIANTS[variant]["mesh"][2]
    for r in ranks[1:]:
        for key in ("loss", "grad_norm"):
            assert torch.equal(r[key], ranks[0][key]), key
        for k in ranks[0]["state_dict"]:
            assert torch.equal(r["state_dict"][k], ranks[0]["state_dict"][k]), k
    shapes = ranks[0]["local_shapes"]
    sharded = [k for k, s in shapes.items() if s != tuple(one["state_dict"][k].shape)]
    assert sharded and len(sharded) < len(shapes)
    for k in sharded:
        whole = tuple(one["state_dict"][k].shape)
        assert sum(a != b for a, b in zip(shapes[k], whole)) == 1 and np.prod(whole) == tp * np.prod(shapes[k]), k


@pytest.mark.parametrize("variant", [v for v, kw in VARIANTS.items() if kw["held"] == "jax"])
def test_step_matches_jax_on_model_mesh(stepped, variant):
    """(1, 1, 2), where JAX's gradient is its one-device gradient within
    1e-5 (module docstring): the loss, the grad norm and every leaf held to
    JAX's; every conv kernel and running statistic moved by at least 5x the
    atol in the step, so a leaf left at its start shows."""
    want, ranks, _, data = stepped[variant]
    r0 = ranks[0]
    np.testing.assert_allclose(float(r0["loss"]), want["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r0["grad_norm"]), want["metrics"]["grad_norm"], rtol=2e-4)
    _hold_state(variant, r0["state_dict"], want["state_dict"], data["state_dict"], 1)


@pytest.mark.parametrize("variant", [v for v, kw in VARIANTS.items() if kw["held"] == "one"])
def test_step_matches_one_process(stepped, variant):
    """Every other mesh: the loss, the grad norm and every leaf held to the
    port's own one-process step; the loss also to JAX's on the same mesh
    where JAX ran it (module docstring: JAX's gradients there are not)."""
    want, ranks, one, data = stepped[variant]
    r0 = ranks[0]
    np.testing.assert_allclose(float(r0["loss"]), float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(r0["grad_norm"]), float(one["grad_norm"]), rtol=2e-4)
    if want is not None:
        np.testing.assert_allclose(float(r0["loss"]), want["metrics"]["loss"], rtol=1e-5)
    _hold_state(variant, r0["state_dict"], one["state_dict"], data["state_dict"],
                VARIANTS[variant].get("accum_steps", 1))


@pytest.mark.parametrize("variant", EVALS)
def test_eval_step_matches_jax_on_model_mesh(stepped, variant):
    """Every rank's eval metrics on the sharded model (its rows: all of
    them on a model-only mesh) against JAX's eval step there."""
    want, ranks, _, _ = stepped[variant]
    want = want["eval"]
    for r in ranks:
        got = r["eval"]
        np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=1e-5)
        for k in ("dice_sum", "iou_sum", "weight_sum", "dice", "iou") + (
                ("dice_class", "iou_class") if "dice_class" in want else ()):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-4, err_msg=k)
        for k in got:
            assert np.array_equal(got[k].numpy(), ranks[0]["eval"][k].numpy()), k
    assert 0.0 < float(want["dice_sum"]) < float(want["weight_sum"])


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
