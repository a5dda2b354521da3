"""GroupNorm in the port (models/unet3d.py ``GroupNorm``, the ``.pth`` bridge,
training, validation) against flax and the JAX package, float32 on the CPU.

Tolerances: GroupNorm outputs within 1e-5·max|ref| of flax's
``nn.GroupNorm`` and its input, scale and bias gradients within
1e-4·max|ref|; logits as ``tests/test_torch_model.py`` (atol 2e-4, rtol
1e-3); three train steps as ``tests/test_torch_train_step.py`` (loss rtol
1e-5, parameters atol 2e-5 with Adam's eps 1e-2; a conv bias before a
GroupNorm group of one channel has a true gradient of 0 and is held to 2·lr
a step); per-case and per-class Dice within 2e-3 of the JAX Validator, the
cross-framework gate of ``tests/test_torch_validate.py``.

The K = 3 GroupNorm cohort (``make_synthetic_dataset(n_classes=3)``, 4 cases
of 20×18×22 voxels) trains for 2 epochs in the port's ``Trainer`` from the
device data cache; both Validators score its ``best.pth``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.infer.validate import Validator as JaxValidator
from pcmseg_tpu.infer.validate import load_model_state as jax_load_model_state
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train import steps as jax_steps
from pcmseg_tpu.train.checkpoints import params_to_torch_state_dict
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.models.unet3d import GroupNorm, UNet3D
from pcmseg_tpu_torch.infer.validate import Validator
from pcmseg_tpu_torch.train import steps
from pcmseg_tpu_torch.train.checkpoints import export_train_checkpoint, load_pth, save_pth, state_dict_from_jax_params
from pcmseg_tpu_torch.train.trainer import Trainer

LR = 1e-3
ATOL = 2e-5
DICE_ATOL = 2e-3
SHAPE = (20, 18, 22)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():  # module scope: the trainer fixture's runs use the same thread count as the tests
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---- the module ----------------------------------------------------------------


@pytest.mark.parametrize("groups,channels", [(8, 16), (4, 16), (8, 4)], ids=["g8_c16", "g4_c16", "g8_c4_min"])
def test_group_norm_matches_flax(groups, channels):
    """Forward and the gradients of x, scale and bias against flax's
    ``nn.GroupNorm(num_groups=min(groups, channels))``, as the JAX model
    builds it (``g8_c4_min``: 4 groups of 1 channel)."""
    rng = np.random.default_rng(groups + channels)
    x = (3.0 * rng.normal(size=(2, 6, 5, 7, channels)) + 1.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.normal(size=channels).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    flax_gn = nn.GroupNorm(num_groups=min(groups, channels), epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias}}
    want = np.asarray(flax_gn.apply(variables, x))
    g_vars, g_x = jax.grad(lambda v, x: jnp.sum(flax_gn.apply(v, x) * dy), argnums=(0, 1))(variables, x)

    gn = GroupNorm(min(groups, channels), channels, eps=1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    got = gn(xt)
    (got * torch.from_numpy(dy)).sum().backward()
    for name, g, w, rel in (("y", got.detach(), want, 1e-5), ("dx", xt.grad, g_x, 1e-4),
                            ("dscale", gn.weight.grad, g_vars["params"]["scale"], 1e-4),
                            ("dbias", gn.bias.grad, g_vars["params"]["bias"], 1e-4)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= rel * np.abs(w).max(), name


def test_group_norm_in_bf16_saves_its_bf16_input_and_group_stats():
    """A bf16 input: the output is flax's bf16 GroupNorm to one bf16
    rounding, and the backward keeps x in bf16 and (N, G) fp32 statistics,
    no fp32 copy of the activations."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 16)).astype(np.float32)).to(torch.bfloat16)
    gn = GroupNorm(8, 16, eps=1e-5)
    saved = []

    def pack(t):
        saved.append((str(t.dtype), t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = gn(x.requires_grad_())
    assert y.dtype == torch.bfloat16
    # x, the scale, the (N, G) mean and rsqrt(var + eps)
    assert sorted(saved) == sorted([("torch.bfloat16", x.numel()), ("torch.float32", 16),
                                    ("torch.float32", 2 * 8), ("torch.float32", 2 * 8)])
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and gn.weight.grad.dtype == torch.float32
    want = nn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}},
        jnp.asarray(x.detach().float().numpy(), jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(y.detach().float().numpy() - want).max() <= 2.0**-8 * np.abs(want).max()


# ---- the model, its weights, three steps -------------------------------------------


def _jax_variables(seed, size, **arch):
    """JAX-initialised GroupNorm variables (numpy), 1-D parameters moved off
    their init."""
    model = JaxUNet3D(base_features=4, remat=False, dtype=jnp.float32, norm_layer="group", **arch)
    init = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, size, size, size, 5)), train=False))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a),
        jax.device_get(init(jax.random.key(seed))))
    assert "batch_stats" not in variables
    return model, variables


def test_binary_logits_match_jax():
    jmodel, variables = _jax_variables(3, 16)
    x = np.random.default_rng(7).normal(size=(2, 16, 24, 20, 5)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    model = UNet3D(base_features=4, norm_layer="group", dtype=torch.float32).eval()
    model.load_state_dict(state_dict_from_jax_params(variables["params"]), strict=True)
    assert [m.num_groups for m in model.inc.conv if isinstance(m, GroupNorm)] == [4, 4]  # min(8, 4)
    assert [m.num_groups for m in model.down4.maxpool_conv[1].conv if isinstance(m, GroupNorm)] == [8, 8]
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        train_mode = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(train_mode, got)  # no running statistics: one arithmetic


def test_pth_bridge_both_ways(tmp_path):
    """JAX → port: the JAX package's exporter and the port's own bridge give
    the same state dict, which loads strictly into ``UNet3D(norm_layer=
    'group')`` and holds no running statistics. Port → JAX: a port model's
    ``.pth`` loads into the JAX package (``load_model_state``) and computes
    the port's logits."""
    jmodel, variables = _jax_variables(4, 16, n_classes=3)
    exported = params_to_torch_state_dict(variables["params"])
    bridged = state_dict_from_jax_params(variables["params"])
    assert sorted(exported) == sorted(bridged) and not [k for k in bridged if "running" in k]
    for k in exported:
        assert torch.equal(exported[k], bridged[k]), k
    assert bridged["outc.weight"].shape == (3, 4, 1, 1, 1)
    UNet3D(base_features=4, n_classes=3, norm_layer="group").load_state_dict(exported, strict=True)

    config = get_config(base_features=4, n_classes=3, norm_layer="group", compute_dtype="float32",
                        target_size=(16, 16, 16), remat=False)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(5)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    pth = save_pth(str(tmp_path / "gn.pth"), model.state_dict(), config.to_dict())
    assert not [k for k in load_pth(pth)[0] if "running" in k]
    jax_config = jax_get_config(**{k: getattr(config, k) for k in (
        "base_features", "n_classes", "norm_layer", "compute_dtype", "target_size", "remat")})
    jmodel, jstate = jax_load_model_state(jax_config, pth)
    x = np.random.default_rng(8).normal(size=(1, 16, 16, 16, 5)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jstate.params}, x, train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_binary_three_steps_match_jax():
    """Three fp32 steps of a binary GroupNorm model under the Dice loss:
    the loss per step, then every parameter."""
    kw = dict(base_features=4, remat=False, compute_dtype="float32", conv_lowering="lax", norm_layer="group",
              target_size=(16, 16, 16), learning_rate=LR, eps=1e-2, weight_decay=1e-2, batch_size=2, loss="dice")
    config = jax_get_config(**kw)
    jmodel, variables = _jax_variables(0, 16)
    rng = np.random.default_rng(1)
    z, y, x = np.meshgrid(*[np.arange(16)] * 3, indexing="ij")
    blob = ((z - 8) ** 2 + (y - 7) ** 2 + (x - 9) ** 2 < 20).astype(np.float32)
    image = rng.normal(size=(2, 16, 16, 16, 5)).astype(np.float32)
    image[..., 0] += 2.0 * blob
    batch = {"image": image, "label": np.stack([blob, np.roll(blob, 3, axis=1)])[..., None]}
    jstate = jax_steps.TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, variables["params"]),
                                         batch_stats={}, ema_params={}, tx=jax_steps.make_optimizer(config))
    jstep = jax.jit(jax_steps.make_train_step(JaxUNet3D.from_config(config), config))
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        jlosses.append(float(m["loss"]))

    port_config = get_config(**kw)
    model = UNet3D.from_config(port_config, device="meta")
    model.load_state_dict(state_dict_from_jax_params(variables["params"]), strict=True, assign=True)
    state = steps.create_train_state(model, port_config)
    step = steps.make_train_step(model, port_config)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    plosses = [float(step(state, tbatch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    want, got = state_dict_from_jax_params(jax.device_get(jstate.params)), model.state_dict()
    assert sorted(got) == sorted(want)
    init = state_dict_from_jax_params(variables["params"])
    for k, w in want.items():
        cancelled = False
        if re.search(r"conv\.[03]\.bias$", k):  # a 3³ conv's bias, GroupNorm after it
            seq, idx, _ = k.rsplit(".", 2)
            norm = model.get_submodule(seq)[int(idx) + 1]
            cancelled = norm.num_channels == norm.num_groups
        d = np.abs(got[k].numpy() - w.numpy()).max()
        assert d <= (2 * LR * 3 if cancelled else ATOL), f"{k}: {d:.3g}"
        if not cancelled:
            assert np.abs(w.numpy() - init[k].numpy()).max() >= 5 * ATOL, f"{k} barely moved"


# ---- the K = 3 GroupNorm trainer and the Validator ----------------------------------


@pytest.fixture(scope="module")
def kclass_run(tmp_path_factory):
    """(data root, the trainer's config, its trainer and history, ``best.pth``
    and the epoch-1 export with their output biases moved
    (``_shift_to_label_shares``), a scratch root)."""
    root = tmp_path_factory.mktemp("torch_groupnorm")
    data = str(root / "data")
    make_synthetic_dataset(data, n_cases=4, shape=SHAPE, seed=21, n_classes=3)
    config = get_config(data_dir=data, save_dir=str(root / "run"), cache_dir=str(root / "cache"),
                        base_features=4, remat=False, compute_dtype="float32", target_size=(16, 16, 16),
                        n_classes=3, norm_layer="group", batch_size=1, num_epochs=2, early_stopping=False,
                        loss="bce_dice", learning_rate=2e-3, val_fraction=0.25, save_frequency=1, seed=0)
    trainer = Trainer(config, device="cpu")
    history = trainer.train()
    member = export_train_checkpoint(os.path.join(config.save_dir, "epoch_1.pt"), str(root / "epoch_1.pth"))
    labels = np.stack([trainer.dataset[i]["label"] for i in range(4)])
    images = torch.from_numpy(np.stack([trainer.dataset[i]["image"] for i in range(4)]))
    shifted = [_shift_to_label_shares(p, str(root / f"shifted_{i}.pth"), config, images, labels)
               for i, p in enumerate((os.path.join(config.save_dir, "best.pth"), member))]
    return data, config, trainer, history, shifted, root


def _shift_to_label_shares(src, dst, config, images, labels):
    """``src`` with class c's output bias moved so that its logit beats class
    0's on the share of voxels that class c holds in ``labels``: two short
    epochs predict almost no foreground, and Dice of empty masks would hold
    the packages to little."""
    model = UNet3D.from_config(config, device="meta")
    sd, snapshot = load_pth(src)
    model.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        logits = model.eval()(images).numpy()
    for c in (1, 2):
        share = float((labels == c).mean())
        sd["outc.bias"][c] -= float(np.quantile(logits[..., c] - logits[..., 0], 1.0 - share))
    return save_pth(dst, sd, snapshot)


def test_kclass_group_norm_trainer_from_the_device_cache(kclass_run):
    """2 epochs from the device cache (class-id uint8 stacks): finite losses,
    the mean foreground Dice in the history, and a ``best.pth`` with
    GroupNorm weights, no running statistics and a 3-class head, which the
    streamed loader's run reproduces."""
    _, config, trainer, history, _, _ = kclass_run
    assert trainer._dcache is not None and trainer._dcache["labels"].dtype == torch.uint8
    assert int(trainer._dcache["labels"].max()) == 2
    assert len(history["train_loss"]) == 2 and all(np.isfinite(v) for v in history["train_loss"] + history["val_loss"])
    assert all(0.0 <= d <= 1.0 for d in history["val_dice"])
    sd, snapshot = load_pth(os.path.join(config.save_dir, "best.pth"))
    assert snapshot["n_classes"] == 3 and snapshot["norm_layer"] == "group"
    assert "inc.conv.1.weight" in sd and "inc.conv.4.bias" in sd and not [k for k in sd if "running" in k]
    assert sd["outc.weight"].shape[0] == 3
    streamed = Trainer(config.replace(device_data_cache_gb=0.0, save_dir=config.save_dir + "_streamed"),
                       device="cpu")
    assert streamed._dcache is None
    assert streamed.train() == history


def _configs(run, name, **overrides):
    """(the JAX package's Validator config, the port's) from the same
    arguments; the checkpoint's snapshot sets the architecture."""
    data, _, _, _, _, root = run
    kw = dict(data_dir=data, cache_dir=str(root / "cache"), compute_dtype="float32", window_size=(16, 16, 16),
              batch_size=4, surface_metrics=True, **overrides)
    return (jax_get_config(save_dir=str(root / name / "jax"), **kw),
            get_config(save_dir=str(root / name / "port"), **kw))


@pytest.mark.parametrize("mode", ["validate", "validate_native", "ensemble_tta"])
def test_per_class_dice_matches_the_jax_validator(kclass_run, mode):
    """The trainer's ``best.pth`` scored by both Validators through the eval
    step (``validate``); the same with its output biases moved to the
    label's class shares, through the unfolded Predictor at the native grid,
    tiled (``validate_native``), and with the moved epoch-1 member as a
    2-member ensemble with TTA and per-class largest-component
    postprocessing (``ensemble_tta``). Per case ``dice``, ``iou`` and each
    ``dice_per_class`` within 2e-3; each case's ``dice`` is the mean of its
    classes."""
    _, config, _, _, shifted, _ = kclass_run
    spec = {"validate": os.path.join(config.save_dir, "best.pth"), "validate_native": shifted[0],
            "ensemble_tta": shifted}[mode]
    extra = dict(tta=True, postprocess="largest_cc") if mode == "ensemble_tta" else {}
    jax_config, port_config = _configs(kclass_run, mode, **extra)
    method = "validate_native" if mode == "validate_native" else "validate"
    want = getattr(JaxValidator(jax_config, spec), method)()
    got = getattr(Validator(port_config, spec, device="cpu"), method)()
    assert sorted(got) == sorted(want) and got["case_count"] == want["case_count"] == 4
    assert ("avg_dice_per_class" in got) == (method == "validate")
    for g, w in zip(got["case_results"], want["case_results"]):
        assert sorted(g) == sorted(w) and g["case_id"] == w["case_id"]
        assert sorted(g["dice_per_class"]) == ["1", "2"]
        for c in ("1", "2"):
            assert abs(g["dice_per_class"][c] - w["dice_per_class"][c]) <= DICE_ATOL, (c, g, w)
        assert abs(g["dice"] - w["dice"]) <= DICE_ATOL and abs(g["iou"] - w["iou"]) <= DICE_ATOL, (g, w)
        assert g["dice"] == pytest.approx(np.mean(list(g["dice_per_class"].values())))
    print(f"{mode}: avg dice {got['avg_dice']:.4f}, per class "
          f"{[r['dice_per_class'] for r in got['case_results']]}")
    if mode != "validate":
        assert got["avg_dice"] > 0.1  # the moved biases predict foreground where the labels hold it
    if method == "validate":
        for c in ("1", "2"):
            assert abs(got["avg_dice_per_class"][c] - want["avg_dice_per_class"][c]) <= DICE_ATOL
