"""Port's deep supervision (models/unet3d.py ds heads, train/steps.py
multiscale loss, train/checkpoints.py) against the JAX package, float32 on
the CPU.

The JAX model's variables, aux heads included, reach the port through
``state_dict_from_jax_params``. Train-mode outputs (logits and the three aux
heads, fine to coarse) within the model test's tolerances; three train
steps within the train-step test's (``tests/test_torch_train_step.py``:
loss rtol 1e-5, the first step's gradient norm rtol 2e-4, params and
running statistics atol 2e-5, the BN-preceded conv biases within 2·lr a
step; Adam's eps as ADAM_EPS says). A ``default_eps`` variant takes one
step with the config's own optimizer (eps 1e-8), where an element whose
gradient is rounding noise moves by ±lr in either package: each element is
held to 2·lr, and each leaf may pass the atol on at most 2·n + 2 elements,
n being the count by which JAX differs from itself with the batch's
samples swapped (as ``test_torch_train_step.py`` holds its own; of the
355k elements, 45 measured beyond the atol against JAX, and 117 of JAX's
against itself). The heads
are training-only: the ``.pth`` that serving and validation take has none
and loads strictly.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train import steps as jax_steps
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.infer.predict import Predictor
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train import steps
from pcmseg_tpu_torch.train.checkpoints import export_train_checkpoint, load_pth, state_dict_from_jax_params
from pcmseg_tpu_torch.train.trainer import Trainer

SIZE = 32
LR = 1e-3
# Adam's eps: 10x the train-step test's 1e-2. The multiscale objective's
# gradients at this init are ~7x the single-scale one's (down1's first conv:
# norm 0.164 against 0.024), with the same relative fp32 rounding noise
# against JAX's (0.5-1.2% of a leaf's norm, either objective), and Adam's
# step lr·g/(|g| + eps) passes that noise on in proportion to g/eps.
ADAM_EPS = 1e-1
ATOL = 2e-5
BN_PRECEDED_BIAS = re.compile(r"conv\.[03]\.bias$")
DEFAULTS = get_config()


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _kw(**kw):
    return dict(dict(base_features=4, remat=False, compute_dtype="float32", target_size=(SIZE,) * 3,
                     learning_rate=LR, eps=ADAM_EPS, weight_decay=1e-2, batch_size=2, deep_supervision=True), **kw)


@pytest.fixture(scope="module")
def init():
    """JAX-initialised deep-supervision variables (numpy), with non-trivial
    1-D params, and a batch of 4."""
    model = JaxUNet3D.from_config(jax_get_config(**_kw(conv_lowering="lax")))
    variables = jax.device_get(
        jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False))(
            jax.random.key(0)))
    assert {"ds1", "ds2", "ds3"} <= set(variables["params"])
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).startswith("['params']") and a.ndim == 1 else np.asarray(a),
        variables,
    )
    z, y, x = np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij")
    blob = ((z - 16) ** 2 + (y - 14) ** 2 + (x - 17) ** 2 < 80).astype(np.float32)
    image = rng.normal(size=(4, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    label = np.stack([np.roll(blob, 3 * i, axis=1) for i in range(4)])[..., None]
    return variables, {"image": image, "label": label}


def _port_model(variables, **kw):
    model = UNet3D.from_config(get_config(**_kw(**kw)), deep_supervision=True, device="meta")
    model.load_state_dict(state_dict_from_jax_params(variables["params"], variables["batch_stats"]),
                          strict=True, assign=True)
    return model


def test_train_mode_outputs_match_jax(init):
    variables, batch = init
    jmodel = JaxUNet3D.from_config(jax_get_config(**_kw(conv_lowering="lax")))
    x = batch["image"][:2]
    (want, want_aux), _ = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    model = _port_model(variables).train()
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x))
        plain = model.eval()(torch.from_numpy(x))
    assert isinstance(plain, torch.Tensor) and plain.shape == got.shape  # eval mode: the logits alone
    assert [a.shape[1] for a in aux] == [SIZE // 2, SIZE // 4, SIZE // 8]  # fine to coarse
    for g, w in zip([got, *aux], [want, *want_aux]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(accum_steps=2, batch_size=4, weight=(1.0, 1.0, 1.0, 0.0)),
    # the config's optimizer, one step, with JAX's own spread as the witness
    dict(eps=DEFAULTS.eps, weight_decay=DEFAULTS.weight_decay, steps=1, witness=True),
], ids=["accum1", "accum2_padded", "default_eps"])
def test_ds_steps_match_jax(init, kw):
    """Three steps of the multiscale loss (DS_WEIGHTS over the full-resolution
    logits and the three heads, labels nearest-resized per scale); one step
    at the config's Adam eps 1e-8, held as the train-step test holds its
    ``default_eps`` variant."""
    variables, batch = init
    kw = dict(kw)
    weight, n_steps, witnessed = kw.pop("weight", None), kw.pop("steps", 3), kw.pop("witness", False)
    jconfig = jax_get_config(**_kw(conv_lowering="lax", **kw))
    config = get_config(**_kw(**kw))
    batch = {k: v[: config.batch_size] for k, v in batch.items()}
    if weight is not None:
        batch["weight"] = np.asarray(weight, np.float32)
    jmodel = JaxUNet3D.from_config(jconfig)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jconfig))

    def run_jax(b):
        jstate, jmetrics = jax_steps.TrainState.create(
            apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            tx=jax_steps.make_optimizer(jconfig)), []
        for _ in range(n_steps):
            jstate, m = jstep(jstate, b)
            jmetrics.append(m)
        return jstate, jmetrics

    jstate, jmetrics = run_jax(batch)
    # JAX's own state from the batch's samples in reverse order: only the rounding changes
    witness = run_jax({k: v[::-1].copy() for k, v in batch.items()})[0] if witnessed else None
    model = _port_model(variables, **kw)
    state = steps.create_train_state(model, config)
    step = steps.make_train_step(model, config)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, jm in enumerate(jmetrics):
        m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2e-4 if i == 0 else 1e-2,
                                   err_msg=f"step {i}")
    want = state_dict_from_jax_params(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    before = state_dict_from_jax_params(variables["params"], variables["batch_stats"])
    witness = witness and state_dict_from_jax_params(jax.device_get(witness.params),
                                                     jax.device_get(witness.batch_stats))
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].numpy(), want[k].numpy()
        d = np.abs(g - w)
        if BN_PRECEDED_BIAS.search(k):
            assert d.max() <= 2 * LR * n_steps, k
            continue
        if witness is None:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)
        else:  # as often beyond the atol as JAX against itself, and never by more than 2·lr a step
            n_self = int((np.abs(witness[k].numpy() - w) > ATOL).sum())
            assert d.max() <= 2 * LR * n_steps, k
            assert int((d > ATOL).sum()) <= 2 * n_self + 2, f"{k}: {int((d > ATOL).sum())} vs JAX's {n_self}"
        if k.startswith("ds") and k.endswith("weight"):  # the heads train: 5x the tolerance, as there
            assert np.abs(w - before[k].numpy()).max() >= 5 * ATOL, f"{k} barely moved"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=4, shape=(18, 16, 17), seed=5)
    return root


def test_pth_has_no_ds_heads_and_serves_and_pt_resumes_with_them(tree, tmp_path):
    config = get_config(data_dir=tree, save_dir=str(tmp_path / "ckpt"), cache_dir=str(tmp_path / "cache"),
                        base_features=4, compute_dtype="float32", target_size=(16, 16, 16), batch_size=2,
                        num_epochs=1, deep_supervision=True, ema_decay=0.9)
    trainer = Trainer(config, device="cpu")
    trainer.train()
    assert {"ds1.weight", "ds3.bias"} <= set(trainer.state.ema)
    for path in (os.path.join(config.save_dir, "best.pth"),
                 export_train_checkpoint(os.path.join(config.save_dir, "latest.pt"), str(tmp_path / "m.pth"))):
        sd, snapshot = load_pth(path)
        assert snapshot["deep_supervision"] and not [k for k in sd if k.startswith("ds")]
        UNet3D.from_config(get_config(**snapshot)).load_state_dict(sd, strict=True)
        mask = Predictor(get_config(), path, device="cpu").predict_mask(
            np.random.default_rng(0).normal(size=(16, 16, 16, 5)).astype(np.float32))
        assert mask.shape == (16, 16, 16) and mask.dtype == np.uint8
    resumed = Trainer(config.replace(resume=True), device="cpu")
    assert resumed.start_epoch == 1
    for name in ("ds1.weight", "ds2.bias", "ds3.weight"):
        assert torch.equal(resumed.state.model.state_dict()[name], trainer.state.model.state_dict()[name])
        assert torch.equal(resumed.state.ema[name], trainer.state.ema[name])


@pytest.mark.parametrize("option", [dict(n_classes=3), dict(norm_layer="group")], ids=lambda o: next(iter(o)))
def test_k_class_and_group_norm_are_still_refused(option):
    """K-class heads and GroupNorm, ported since, are no longer refused: a
    deep-supervision step of either takes every head's loss (3 outputs each
    for K = 3) and moves every head (tests/test_torch_kclass.py holds the
    K = 3 GroupNorm step against JAX)."""
    config = get_config(**_kw(target_size=(16,) * 3, **option))
    model = UNet3D.from_config(config, deep_supervision=True, generator=torch.Generator().manual_seed(0))
    state = steps.create_train_state(model, config)
    before = {f"ds{i}": getattr(model, f"ds{i}").weight.detach().clone() for i in (1, 2, 3)}
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.normal(size=(2, 16, 16, 16, 5)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, config.n_classes + 1, (2, 16, 16, 16, 1)).astype(np.uint8))}
    assert np.isfinite(float(steps.make_train_step(model, config)(state, batch)["loss"]))
    for name, w in before.items():
        assert w.shape[0] == config.n_classes and not torch.equal(getattr(model, name).weight, w), name
