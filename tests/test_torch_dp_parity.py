"""The port's data-parallel train step on 2 (and 4) gloo processes against
the JAX package's train step on a 2-device (4-device) 'data' mesh
(``make_mesh(2, 1, 1)`` over the conftest's virtual CPU devices), float32,
one step from the same JAX-initialised weights on the same seeded numpy
batch.

The port's workers are this file itself, started by ``subprocess``
(``python tests/test_torch_dp_parity.py PID NPROC PORT INPUTS OUT``, one
cluster for the variants of each size, with a timeout); each rank takes
its rows of the global batch (``sharding.shard_batch``) and runs
``make_train_step``.

Variants: layout (a) with batch 4, accum 1 (2 rows a rank), the same with a
padded ragged batch (weights 1, 1, 1, 0: rank 1 holds the padded row);
layout (b) with batch 4, accum 4 (each rank 2 whole microbatches of one
sample, the BatchNorm running statistics replayed over all 4 in order: a
chain that a rank's own two microbatches, or the wrong order, would leave
elsewhere); a K = 3 model in layout (a) with 2 microbatches (a rank's
rows interleaved); and layout (c) on 4 processes with batch 4, accum 2
(4 ranks divide neither the microbatch of 2 nor the 2 microbatches: two
groups of 2 ranks, each group one microbatch, a row a rank, BatchNorm and
the loss summed over the group, the running statistics replayed over both
microbatches in order), against JAX on ``make_mesh(4, 1, 1)``.

Tolerances, as ``tests/test_torch_train_step.py`` sets them and for the same
reasons (32³, Adam eps 1e-2, lr 1e-3): the loss to rtol 1e-5, the pre-clip
grad norm to rtol 2e-4, every parameter and BN running statistic to atol
2e-5, the biases of the BN-preceded 3³ convs (true gradient 0) to 2·lr.
Every rank holds bitwise-equal states and metrics.
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
BN_PRECEDED_BIAS = re.compile(r"conv\.[03]\.bias$")
VARIANTS = {
    "a_accum1": dict(batch_size=4),
    "a_padded": dict(batch_size=4, weight=(1.0, 1.0, 1.0, 0.0)),
    "b_accum4": dict(batch_size=4, accum_steps=4),
    "k3_a_accum2": dict(batch_size=4, accum_steps=2, n_classes=3, loss="bce_dice"),
    "c_accum2": dict(batch_size=4, accum_steps=2, ranks=4),
}


def _ranks(variant) -> int:
    return VARIANTS[variant].get("ranks", 2)


def _kwargs(variant):
    kw = {k: v for k, v in VARIANTS[variant].items() if k not in ("weight", "ranks")}
    return dict(base_features=4, remat=False, compute_dtype="float32", target_size=(SIZE,) * 3,
                learning_rate=LR, eps=1e-2, weight_decay=1e-2, **kw)


def _worker(pid: int, nproc: int, port: int, inputs: str, out: str) -> int:
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch
    from pcmseg_tpu_torch.train import steps

    torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    results = {}
    for variant, given in torch.load(inputs, weights_only=True).items():
        if _ranks(variant) != nproc:
            continue
        config = get_config(**_kwargs(variant))
        model = UNet3D.from_config(config, device="meta")
        model.load_state_dict(given["state_dict"], strict=True, assign=True)
        state = steps.create_train_state(model, config)
        local = shard_batch(given["batch"], Mesh(nproc), rank=pid, accum=config.accum_steps)
        metrics = steps.make_train_step(model, config)(state, local)
        results[variant] = {"state_dict": model.state_dict(), **{k: v.detach() for k, v in metrics.items()}}
    torch.save(results, f"{out}.{pid}.pt")
    multihost.shutdown()
    return 0


def _init(n_classes, rng):
    """JAX-initialised variables (numpy) with non-trivial BN affines and biases."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D.from_config(get_config(base_features=4, n_classes=n_classes, conv_lowering="lax"))
    variables = jax.jit(
        lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False)
    )(jax.random.key(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).startswith("['params']") and a.ndim == 1
        else np.asarray(a),
        jax.device_get(variables),
    )


def _batch(n_classes, rng, weight):
    z, y, x = np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij")
    blob = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 80).astype(np.float32)
    image = rng.normal(size=(4, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    # samples of other intensities: the microbatches' BatchNorm statistics differ
    image *= np.float32(1.0) + np.float32(0.5) * np.arange(4, dtype=np.float32)[:, None, None, None, None]
    label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(4)])[..., None]
    if n_classes == 3:
        core = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 20)
        label = (label + np.stack([np.roll(core, 3 * i, axis=1) for i in range(4)])[..., None]).astype(np.int32)
    batch = {"image": image, "label": label}
    if weight is not None:
        batch["weight"] = np.asarray(weight, np.float32)
    return batch


def _jax_step(variant, variables, batch):
    """(state dict after one step, metrics) of JAX's step on the variant's 'data' mesh."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.parallel.sharding import make_mesh, shard_batch, shard_state
    from pcmseg_tpu.train import steps as jax_steps
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    config = get_config(conv_lowering="lax", **_kwargs(variant))
    model = JaxUNet3D.from_config(config)
    state = jax_steps.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]), ema_params={},
        tx=jax_steps.make_optimizer(config),
    )
    mesh = make_mesh(_ranks(variant), 1, 1, devices=jax.devices()[: _ranks(variant)])
    state = shard_state(state, mesh)
    state, metrics = jax.jit(jax_steps.make_train_step(model, config))(state, shard_batch(batch, mesh))
    got = jax.device_get((state.params, state.batch_stats))
    return state_dict_from_jax_params(*got), {k: float(v) for k, v in metrics.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Per variant: (JAX's state dict and metrics, every rank's results, the
    initial state dict, the batch)."""
    import torch

    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    tmp = tmp_path_factory.mktemp("dp_parity")
    rng = np.random.default_rng(1)
    inits = {k: _init(k, rng) for k in (1, 3)}
    inputs, batches = {}, {}
    for variant, kw in VARIANTS.items():
        k = kw.get("n_classes", 1)
        batches[variant] = _batch(k, rng, kw.get("weight"))
        inputs[variant] = {
            "state_dict": state_dict_from_jax_params(inits[k]["params"], inits[k]["batch_stats"]),
            "batch": {key: torch.from_numpy(v) for key, v in batches[variant].items()},
        }
    torch.save(inputs, str(tmp / "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    sizes = sorted({_ranks(v) for v in VARIANTS})
    out = {n: str(tmp / f"out{n}") for n in sizes}
    procs = []
    for n in sizes:  # one cluster of each size, all at once
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(n), str(port),
                                    str(tmp / "inputs.pt"), out[n]],
                                   cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for pid in range(n)]
    try:
        # JAX's steps compile and run while the port's clusters work
        want = {v: _jax_step(v, inits[VARIANTS[v].get("n_classes", 1)], batches[v]) for v in VARIANTS}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    ranks = {n: [torch.load(f"{out[n]}.{pid}.pt", weights_only=True) for pid in range(n)] for n in sizes}
    return {v: (want[v], [r[v] for r in ranks[_ranks(v)]], inputs[v]["state_dict"], batches[v]) for v in VARIANTS}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ranks_hold_bitwise_equal_states(stepped, variant):
    import torch

    _, (r0, *others), _, _ = stepped[variant]
    for r1 in others:
        assert sorted(r0) == sorted(r1)
        for key in ("loss", "grad_norm"):
            assert torch.equal(r0[key], r1[key]), key
        for k in r0["state_dict"]:
            assert torch.equal(r0["state_dict"][k], r1["state_dict"][k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grad_norm_match_jax(stepped, variant):
    (_, metrics), (r0, *_), _, _ = stepped[variant]
    np.testing.assert_allclose(float(r0["loss"]), metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r0["grad_norm"]), metrics["grad_norm"], rtol=2e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_and_running_stats_match_jax(stepped, variant):
    """Every leaf to atol 2e-5 (BN-preceded conv biases to 2·lr), the BN
    running statistics included; every conv kernel and running statistic
    moved by at least 5x the atol in the step, so a leaf left at its start
    shows (a bias whose gradient is small may move less in one step)."""
    (want, _), (r0, *_), init, _ = stepped[variant]
    got = dict(r0["state_dict"])
    accum = VARIANTS[variant].get("accum_steps", 1)
    for k in [k for k in got if k.endswith("num_batches_tracked")]:
        assert int(got.pop(k)) == accum
        want.pop(k)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if BN_PRECEDED_BIAS.search(k):
            assert np.abs(g - w).max() <= 2 * LR, f"{variant} {k}"
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{variant} {k}")
        if w.ndim > 1 or "running" in k:
            assert np.abs(w - init[k].numpy()).max() >= 5 * ATOL, f"{variant} {k} barely moved"


def test_layout_b_running_stats_are_the_global_chain(stepped):
    """In layout (b) each rank runs 2 of the 4 microbatches. The first
    BatchNorm's running mean, recomputed here from each microbatch's
    statistics, matches JAX's only as the chain over all four in order: the
    chain over a rank's own two, or over the four in reverse, lies far from
    it."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D

    (want, _), (r0, *_), init, batch = stepped["b_accum4"]
    key = "inc.conv.1.running_mean"
    model = UNet3D.from_config(get_config(**_kwargs("b_accum4")), device="meta")
    model.load_state_dict(init, strict=True, assign=True)
    with torch.no_grad():
        images = torch.from_numpy(batch["image"])
        means = [model.inc.conv[0](images[i: i + 1]).mean((0, 1, 2, 3)) for i in range(4)]

    def chain(order):
        r = init[key].clone()
        for i in order:
            r = 0.9 * r + 0.1 * means[i]
        return r.numpy()

    jax_mean, port_mean = want[key].numpy(), r0["state_dict"][key].numpy()
    assert np.abs(port_mean - jax_mean).max() <= ATOL
    assert np.abs(chain([0, 1, 2, 3]) - jax_mean).max() <= ATOL
    for wrong in ([0, 1], [2, 3], [3, 2, 1, 0]):
        assert np.abs(chain(wrong) - jax_mean).max() > 10 * ATOL, wrong


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
