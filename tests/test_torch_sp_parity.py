"""The port's spatially sharded train and eval steps, Predictor and Trainer
against the JAX package's, on the CPU.

Steps: gloo clusters whose workers are this file itself, started by
``subprocess`` (``python tests/test_torch_sp_parity.py PID NPROC PORT
INPUTS OUT``, each with a timeout), 2 processes on a data 1 × spatial 2
mesh and 4 on a data 2 × spatial 2 mesh; each rank takes its rows and its
D-slab of the global batch (``sharding.shard_batch``) and runs
``make_train_step`` once, against JAX's ``make_train_step`` on
``make_mesh(1, 2, 1)`` / ``make_mesh(2, 2, 1)`` over the conftest's virtual
CPU devices (GSPMD's halo exchanges), float32, base 4, 32³, from the same
JAX-initialised weights on the same seeded numpy batch. Variants: BN in
layout (a) on both meshes; BN in layout (b) (batch 4 as 4 microbatches,
each data rank 2 of them, the running statistics replayed over all 4) on
the 2 × 2 mesh; a K = 3 GroupNorm model and a deep-supervision model (its
coarse heads at 1/2, 1/4 and 1/8 scored on the rows each rank owns) on the
1 × 2 mesh. Then the eval step's loss, per-sample Dice/IoU and sums on
both meshes (one sample weighted 0), against JAX's eval step there.

JAX's own gradient on ``make_mesh(2, 2, 1)`` is off: with the loss equal
to its one-device loss, its grad norm is 0.0998 against 0.0761 and its
conv kernel and BatchNorm scale gradients lie up to 2.08 and 4.17 times
their largest entry from its one-device ones, where on ``(2, 1, 1)``,
``(4, 1, 1)``, ``(1, 2, 1)`` and ``(1, 4, 1)`` they stay within 0.032
(``tools/jax_spatial_grads.py``; ROADMAP.md queue C). On the 2 × 2 mesh
the port's step is therefore held to JAX's loss there and to JAX's state
and grad norm on ``make_mesh(2, 1, 1)``, the same rows over 2 devices
without the D split (the port's own step gives the same numbers on all
these meshes).

Tolerances, ``tests/test_torch_dp_parity.py``'s (32³, Adam eps 1e-2, lr
1e-3, one step): the loss to rtol 1e-5, the pre-clip grad norm to rtol
2e-4, every parameter and BN running statistic to atol 2e-5, the biases
that the norm after them cancels (true gradient 0) to 2·lr; the eval
step's loss to rtol 1e-5 and its Dice/IoU to atol 1e-4 (a voxel whose
logit lies within rounding of the threshold may flip). The ranks of a
cluster hold bitwise-equal states and metrics.

Serving: the port's Predictor with ``spatial_parallel=4`` over four CPU
shard threads against its unsharded Predictor and against the JAX
Predictor with ``spatial_parallel=4`` on the same ``.pth`` (after
``tests/test_tta.py:150-181``), and the capacity case (D = 32, window 16:
the sharded Predictor serves the volume whole, the unsharded one tiles;
``tests/test_tta.py:184-215``).

Trainer: the 2-process cluster also trains a spatial Trainer (data 1 ×
spatial 2) for 2 epochs at 16³, streamed and from the device cache; the
two histories are bitwise equal, and equal to one process's within
``tests/test_torch_multihost.py``'s bounds.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
LR = 1e-3
ATOL = 2e-5
CONV_BIAS = re.compile(r"conv\.[03]\.bias$")
# name -> (data, spatial) mesh and the config's differences
VARIANTS = {
    "m12_bn_a": dict(mesh=(1, 2), batch_size=2),
    "m12_k3_group": dict(mesh=(1, 2), batch_size=2, n_classes=3, norm_layer="group", loss="bce_dice"),
    "m12_ds": dict(mesh=(1, 2), batch_size=2, deep_supervision=True),
    "m22_bn_a": dict(mesh=(2, 2), batch_size=4),
    "m22_bn_b": dict(mesh=(2, 2), batch_size=4, accum_steps=4),
}
# the mesh of JAX's state and grad norm, where it is not the variant's (module docstring)
JAX_STATE_MESH = {"m22_bn_a": (2, 1), "m22_bn_b": (2, 1)}
EVALS = ("m12_k3_group", "m22_bn_a")
TRAINER = dict(batch_size=4, accum_steps=2, num_epochs=2, validation=True, eps=1e-2, base_features=4,
               remat=False, compute_dtype="float32", target_size=(16, 16, 16), early_stopping=False)


def _kwargs(variant):
    kw = {k: v for k, v in VARIANTS[variant].items() if k != "mesh"}
    return dict(base_features=4, remat=False, compute_dtype="float32", target_size=(SIZE,) * 3,
                learning_rate=LR, eps=1e-2, weight_decay=1e-2, **kw)


def _trainer_config(data_dir, save_dir, **kw):
    from pcmseg_tpu_torch.core.config import get_config

    return get_config("quick", data_dir=data_dir, save_dir=save_dir, **dict(TRAINER, **kw))


def _worker(pid: int, nproc: int, port: int, inputs: str, out: str) -> int:
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch
    from pcmseg_tpu_torch.train import steps

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    given = torch.load(inputs, weights_only=True)
    results = {}
    for variant, data in given["variants"].items():
        config = get_config(**_kwargs(variant))
        mesh = Mesh(*VARIANTS[variant]["mesh"])
        model = UNet3D.from_config(config, deep_supervision=config.deep_supervision, device="meta")
        model.load_state_dict(data["state_dict"], strict=True, assign=True)
        results[variant] = {}
        if variant in EVALS:
            local = shard_batch(dict(data["batch"], weight=data["eval_weight"]), mesh, rank=pid)
            got = steps.make_eval_step(model, config, mesh=mesh)(steps.TrainState(model=model, optimizer=None), local)
            results[variant]["eval"] = {k: v for k, v in got.items()}
        state = steps.create_train_state(model, config)
        local = shard_batch(data["batch"], mesh, rank=pid, accum=config.accum_steps)
        metrics = steps.make_train_step(model, config, mesh=mesh)(state, local)
        results[variant].update(state_dict=model.state_dict(), **{k: v.detach() for k, v in metrics.items()})
    if "trainer" in given:
        from pcmseg_tpu_torch.train.trainer import Trainer

        histories = {}
        for name, gb in (("streamed", 0.0), ("cached", 1.0)):
            config = _trainer_config(given["trainer"], os.path.join(out + ".ckpt", name), spatial_parallel=nproc,
                                     device_data_cache_gb=gb)
            trainer = Trainer(config, device="cpu")
            assert trainer.mesh.shape == {"data": 1, "spatial": nproc, "model": 1}
            assert (trainer._dcache is not None) == (gb > 0)
            histories[name] = trainer.train()
        results["trainer"] = histories
    torch.save(results, f"{out}.{pid}.pt")
    multihost.shutdown()
    return 0


def _init(n_classes, norm_layer, deep_supervision, rng):
    """JAX-initialised variables (numpy) with every 1-D parameter moved off its init."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D.from_config(get_config(base_features=4, n_classes=n_classes, norm_layer=norm_layer,
                                             deep_supervision=deep_supervision, conv_lowering="lax"))
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


def _jax_state(variant, variables, mesh):
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.parallel.sharding import shard_state
    from pcmseg_tpu.train import steps as jax_steps

    config = get_config(conv_lowering="lax", **_kwargs(variant))
    model = JaxUNet3D.from_config(config)
    state = jax_steps.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})), ema_params={},
        tx=jax_steps.make_optimizer(config),
    )
    return config, model, shard_state(state, mesh)


def _jax_results(variant, variables, batch, eval_weight):
    """JAX's eval metrics (on EVALS) and (state dict, metrics) after one
    train step, on the variant's ('data', 'spatial') mesh; the state and
    the grad norm on ``JAX_STATE_MESH``'s where it names one."""
    import jax

    from pcmseg_tpu.parallel.sharding import make_mesh, shard_batch
    from pcmseg_tpu.train import steps as jax_steps
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    out = {}
    for dp, sp in dict.fromkeys([VARIANTS[variant]["mesh"], JAX_STATE_MESH.get(variant, VARIANTS[variant]["mesh"])]):
        mesh = make_mesh(dp, sp, 1, devices=jax.devices()[: dp * sp])
        config, model, state = _jax_state(variant, variables, mesh)
        if variant in EVALS and "eval" not in out:
            got = jax.jit(jax_steps.make_eval_step(model, config))(
                state, shard_batch(dict(batch, weight=eval_weight), mesh))
            out["eval"] = {k: np.asarray(v) for k, v in got.items()}
        state, metrics = jax.jit(jax_steps.make_train_step(model, config))(state, shard_batch(batch, mesh))
        stats = jax.device_get(state.batch_stats) if state.batch_stats else None
        out.setdefault("loss", float(metrics["loss"]))  # on the variant's mesh
        out.update(state_dict=state_dict_from_jax_params(jax.device_get(state.params), stats),
                   metrics={k: float(v) for k, v in metrics.items()})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(nproc, inputs, out):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(nproc), str(port), inputs, out],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(nproc)]


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    from pcmseg_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("sp_cases"))
    make_synthetic_dataset(root, n_cases=6, shape=(12, 12, 12), seed=7)
    return root


@pytest.fixture(scope="module")
def stepped(tmp_path_factory, data_tree):
    """Per variant: (JAX's results, every rank's results, the initial state
    dict, the batch); and the 2-process cluster's Trainer histories."""
    import torch

    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    tmp = tmp_path_factory.mktemp("sp_parity")
    rng = np.random.default_rng(1)
    inits, batches, inputs = {}, {}, {1: {"variants": {}}, 2: {"variants": {}}}
    for variant, kw in VARIANTS.items():
        arch = (kw.get("n_classes", 1), kw.get("norm_layer", "batch"), kw.get("deep_supervision", False))
        if arch not in inits:
            inits[arch] = _init(*arch, rng)
        batches[variant] = _batch(kw["batch_size"], arch[0], rng)
        variables = inits[arch]
        entry = {"state_dict": state_dict_from_jax_params(variables["params"], variables.get("batch_stats")),
                 "batch": {k: torch.from_numpy(v) for k, v in batches[variant].items()},
                 "eval_weight": torch.ones(kw["batch_size"]).index_fill_(0, torch.tensor([1]), 0.0)}
        inputs[kw["mesh"][0]]["variants"][variant] = entry
    inputs[1]["trainer"] = data_tree
    procs = {}
    for dp, given in inputs.items():
        torch.save(given, str(tmp / f"inputs{dp}.pt"))
        procs[dp] = _spawn(2 * dp, str(tmp / f"inputs{dp}.pt"), str(tmp / f"out{dp}"))
    try:
        # JAX's steps compile and run while the port's clusters work
        want = {}
        for variant, kw in VARIANTS.items():
            arch = (kw.get("n_classes", 1), kw.get("norm_layer", "batch"), kw.get("deep_supervision", False))
            weight = inputs[kw["mesh"][0]]["variants"][variant]["eval_weight"].numpy()
            want[variant] = _jax_results(variant, inits[arch], batches[variant], weight)
        outs = {dp: [p.communicate(timeout=420)[0] for p in ps] for dp, ps in procs.items()}
    finally:
        for p in sum(procs.values(), []):
            if p.poll() is None:
                p.kill()
                p.communicate()
    for dp, ps in procs.items():
        for p, o in zip(ps, outs[dp]):
            assert p.returncode == 0, o[-4000:]
    ranks = {dp: [torch.load(str(tmp / f"out{dp}.{pid}.pt"), weights_only=True) for pid in range(2 * dp)]
             for dp in procs}
    cases = {v: (want[v], [r[v] for r in ranks[kw["mesh"][0]]], inputs[kw["mesh"][0]]["variants"][v], batches[v])
             for v, kw in VARIANTS.items()}
    return cases, [r["trainer"] for r in ranks[1]]


def _cancelled_bias(name, state_dict):
    """Whether the norm after conv ``name`` takes its bias out: BatchNorm, or
    GroupNorm with one channel per group (then 'weight' of the norm has as
    many entries as it has groups; base 4 gives 4 and 8 channels at 8 groups)."""
    if not CONV_BIAS.search(name):
        return False
    norm = name.rsplit(".", 2)[0] + "." + str(int(name.rsplit(".", 2)[1]) + 1)
    if norm + ".running_mean" in state_dict:
        return True
    return state_dict[norm + ".weight"].numel() <= 8


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ranks_hold_bitwise_equal_states(stepped, variant):
    import torch

    _, ranks, _, _ = stepped[0][variant]
    for r in ranks[1:]:
        for key in ("loss", "grad_norm"):
            assert torch.equal(r[key], ranks[0][key]), key
        for k in ranks[0]["state_dict"]:
            assert torch.equal(r["state_dict"][k], ranks[0]["state_dict"][k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_matches_jax_on_its_mesh(stepped, variant):
    """The loss and grad norm; every leaf to atol 2e-5 (cancelled biases to
    2·lr); every conv kernel and running statistic moved by at least 5x
    the atol in the step, so a leaf left at its start shows. On the 2 × 2
    mesh, the state and grad norm of JAX on 2 × 1 (module docstring)."""
    want, ranks, init, _ = stepped[0][variant]
    r0 = ranks[0]
    np.testing.assert_allclose(float(r0["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r0["loss"]), want["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r0["grad_norm"]), want["metrics"]["grad_norm"], rtol=2e-4)
    got, expect = dict(r0["state_dict"]), dict(want["state_dict"])
    accum = VARIANTS[variant].get("accum_steps", 1)
    for k in [k for k in got if k.endswith("num_batches_tracked")]:
        assert int(got.pop(k)) == accum
        expect.pop(k)
    assert sorted(got) == sorted(expect)
    for k, w in expect.items():
        g, w = got[k].numpy(), w.numpy()
        if _cancelled_bias(k, got):
            assert np.abs(g - w).max() <= 2 * LR, f"{variant} {k}"
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{variant} {k}")
        if w.ndim > 1 or "running" in k:
            assert np.abs(w - init["state_dict"][k].numpy()).max() >= 5 * ATOL, f"{variant} {k} barely moved"


@pytest.mark.parametrize("variant", EVALS)
def test_eval_step_matches_jax_on_its_mesh(stepped, variant):
    """Per rank, the per-sample Dice/IoU of its rows (summed over the D-slabs)
    and the global loss and sums, against JAX's eval step."""
    want, ranks, _, _ = stepped[0][variant]
    dp, sp = VARIANTS[variant]["mesh"]
    want = want["eval"]
    rows = VARIANTS[variant]["batch_size"] // dp
    for pid, r in enumerate(ranks):
        got, d = r["eval"], pid // sp
        np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=1e-5)
        for k in ("dice_sum", "iou_sum", "weight_sum"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-4, err_msg=k)
        for k in ("dice", "iou") + (("dice_class", "iou_class") if "dice_class" in want else ()):
            np.testing.assert_allclose(got[k].numpy(), want[k][d * rows: (d + 1) * rows], rtol=0, atol=1e-4, err_msg=k)
    assert 0.0 < float(want["dice_sum"]) < float(want["weight_sum"])


def test_spatial_trainer_matches_one_process(stepped, data_tree, tmp_path):
    """Both ranks' histories are equal, the cached run's to the streamed
    run's bit for bit, and within the multihost test's bounds of one
    process without a group."""
    import torch

    from pcmseg_tpu_torch.train.trainer import Trainer

    histories = stepped[1]
    assert histories[0] == histories[1]
    assert histories[0]["cached"] == histories[0]["streamed"]
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = Trainer(_trainer_config(data_tree, str(tmp_path / "one")), device="cpu").train()
    finally:
        torch.set_num_threads(prev)
    got = histories[0]["streamed"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=0, err_msg=key)
    for key in ("val_dice", "val_iou"):
        np.testing.assert_allclose(got[key], one[key], rtol=0, atol=5e-4, err_msg=key)


# ---- serving ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A .pth exported by the JAX package from seeded weights, and both packages' configs."""
    import jax

    from pcmseg_tpu.core.config import get_config as jax_get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.train.checkpoints import export_torch_checkpoint
    from pcmseg_tpu.train.steps import create_train_state
    from pcmseg_tpu_torch.core.config import get_config

    kw = dict(base_features=4, window_size=(16, 16, 16), target_size=(16, 16, 16), compute_dtype="float32")
    jax_config, config = jax_get_config(**kw), get_config(**kw)
    state = create_train_state(jax_config, jax.random.key(3), JaxUNet3D.from_config(jax_config), (1, 16, 16, 16, 5))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if str(path[-1]) == "['var']"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        jax.device_get(state.batch_stats))
    pth = str(tmp_path_factory.mktemp("sp_serving") / "model.pth")
    export_torch_checkpoint(pth, state.replace(batch_stats=stats), meta={"config": jax_config.to_dict()})
    return pth, jax_config, config


@pytest.mark.parametrize("depth", [16, 32], ids=["whole", "capacity"])
def test_sharded_predictor_matches_unsharded_and_jax(served, depth):
    """D = 16: four shards hold 4 slices each (levels 3 and 4 gathered).
    D = 32 over window 16: the sharded Predictors (port and JAX) serve the
    volume whole, the unsharded port Predictor tiles it, so only the
    sharded ones are held to each other tightly and the tiled one to the
    blend's bound."""
    from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
    from pcmseg_tpu_torch.infer.predict import Predictor

    pth, jax_config, config = served
    image = np.random.default_rng(5).random((depth, 16, 16, 5)).astype(np.float32)
    plain = Predictor(config, pth, device="cpu")
    sharded = Predictor(config.replace(spatial_parallel=4), pth, device="cpu", shard_devices=["cpu"] * 4)
    jax_sp = JaxPredictor(jax_config.replace(spatial_parallel=4), pth)
    out_plain, out_sp = plain.predict_probs(image), sharded.predict_probs(image)
    want = np.asarray(jax_sp.predict_probs(image))
    assert jax_sp._spatial_sharded and not jax_sp._sw_fns
    assert not sharded._sw_fns and bool(plain._sw_fns) == (depth > 16)
    assert out_sp.shape == out_plain.shape == want.shape == (depth, 16, 16, 1)
    np.testing.assert_allclose(out_sp, want, atol=1e-5)
    if depth == 16:
        np.testing.assert_allclose(out_sp, out_plain, atol=1e-5)
        whole = Predictor(config.replace(spatial_parallel=4), pth, device="cpu")  # one CPU device: unsharded
        assert whole.shards is None
        np.testing.assert_allclose(whole.predict_probs(image), out_plain, atol=0)
    else:
        assert np.isfinite(out_plain).all() and np.abs(out_plain - out_sp).max() < 0.5


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
