"""K-class heads in the port (ops/losses.py, models/unet3d.py, train/steps.py,
infer/predict.py, infer/serve.py) against the JAX package, float32 on the
CPU.

Tolerances:
  * each K-class loss (dice, bce_dice, tversky, focal, focal_dice) to rtol
    1e-5 and its gradient to atol 1e-6, with and without a per-sample
    ``weight``;
  * K = 3 logits (BatchNorm and GroupNorm) as ``tests/test_torch_model.py``
    holds the binary ones: atol 2e-4, rtol 1e-3;
  * three train steps as ``tests/test_torch_train_step.py`` holds them: the
    loss per step to rtol 1e-5, the parameters (and BN running statistics)
    after to atol 2e-5, with Adam's eps raised as there (1e-2; 1e-1 under
    deep supervision, as ``tests/test_torch_deep_supervision.py``). A conv
    bias whose norm cancels it (BatchNorm, or a GroupNorm group of one
    channel) has a true gradient of 0, a computed one of rounding noise, and
    is held to 2·lr a step. The BatchNorm variant runs at 32³ (at 16³ its
    bottleneck sees 2 values per channel), the GroupNorm ones at 16³;
  * label maps equal to JAX's at every voxel whose top two JAX
    probabilities differ by more than TIE (argmax takes the first maximum in
    both packages, but an fp32 difference in the last bit can flip a
    near-tie); the count of the other voxels is printed. Probabilities to
    atol 2e-4, as ``tests/test_torch_serving.py``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.nifti import write_nifti
from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.ops import losses as jax_losses
from pcmseg_tpu.train import steps as jax_steps
from pcmseg_tpu.train.checkpoints import export_torch_checkpoint
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data.io import read_volume
from pcmseg_tpu_torch.infer.predict import Predictor
from pcmseg_tpu_torch.infer.serve import PredictionServer
from pcmseg_tpu_torch.models.unet3d import GroupNorm, UNet3D
from pcmseg_tpu_torch.ops import losses
from pcmseg_tpu_torch.train import steps
from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth, state_dict_from_jax_params

K = 3
LR = 1e-3
ATOL = 2e-5
PROB_ATOL = 2e-4
TIE = 1e-5
LOSS_NAMES = ("dice", "bce_dice", "tversky", "focal", "focal_dice")
CONV_BIAS = re.compile(r"conv\.[03]\.bias$")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _labels(rng, shape):
    """(N, D, H, W, 1) class maps: two overlapping blobs of classes 1 and 2
    on background, moved per sample."""
    n, d, h, w = shape
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    out = np.zeros(shape, np.uint8)
    for i in range(n):
        c = rng.uniform(0.3, 0.7, 3) * (d, h, w)
        r2 = (z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2
        out[i][r2 < (0.3 * d) ** 2] = 1
        out[i][r2 < (0.15 * d) ** 2] = 2
    return out[..., None]


def _top2_gap(probs):
    """Gap between the largest and the second largest probability per voxel."""
    top = np.sort(probs, axis=-1)
    return top[..., -1] - top[..., -2]


def _assert_labels_match(got, want, probs, what):
    decided = _top2_gap(probs) > TIE
    print(f"{what}: {int((~decided).sum())} tie voxels of {decided.size} (top-two gap <= {TIE})")
    np.testing.assert_array_equal(got[decided], want[decided], err_msg=what)


# ---- losses ------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_data():
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.normal(size=(3, 8, 6, 5, K))).astype(np.float32)
    return logits, _labels(rng, (3, 8, 6, 5))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_and_gradient_match_jax(loss_data, name, weighted):
    logits, labels = loss_data
    weight = np.asarray([1.0, 0.0, 1.0], np.float32) if weighted else None
    jfn = jax_losses.make_loss_fn(name, n_classes=K)
    want, want_g = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels), weight))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = losses.make_loss_fn(name, n_classes=K)(t, torch.from_numpy(labels),
                                                  None if weight is None else torch.from_numpy(weight))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)


def test_background_is_scored_by_the_standalone_overlap_losses_only(loss_data):
    """'dice' and 'tversky' include class 0; the composites' Dice does not."""
    logits, labels = (torch.from_numpy(a) for a in loss_data)
    assert losses.make_loss_fn("dice", n_classes=K)(logits, labels) == losses.softmax_dice_loss(
        logits, labels, include_background=True)
    composite = losses.make_loss_fn("bce_dice", n_classes=K)(logits, labels)
    torch.testing.assert_close(composite, 0.5 * losses.ce_loss(logits, labels)
                               + 0.5 * losses.softmax_dice_loss(logits, labels))
    assert losses.softmax_dice_loss(logits, labels) != losses.softmax_dice_loss(
        logits, labels, include_background=True)


def test_focal_at_saturated_logits_has_no_nan(loss_data):
    _, labels = loss_data
    one_hot = np.eye(K, dtype=np.float32)[labels[..., 0]]
    logits = torch.from_numpy(200.0 * one_hot - 100.0).requires_grad_()  # p_t == 1 in fp32
    for name in ("focal", "focal_dice"):
        logits.grad = None
        loss = losses.make_loss_fn(name, n_classes=K)(logits, torch.from_numpy(labels))
        loss.backward()
        assert torch.isfinite(loss) and bool(torch.isfinite(logits.grad).all()), name
    assert losses.mc_focal_loss(logits, torch.from_numpy(labels)).item() == pytest.approx(0.0, abs=1e-12)


def test_one_hot_reads_class_ids_of_any_integer_or_float_dtype():
    ids = torch.tensor([[0], [2], [1], [3]])
    want = torch.tensor([[1.0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 0, 0]])  # 3 is out of range: zeros, as JAX
    for dtype in (torch.uint8, torch.int64, torch.float32, torch.bfloat16):
        assert torch.equal(losses.one_hot_targets(ids.to(dtype), K), want), dtype
    np.testing.assert_array_equal(want.numpy(), np.asarray(jax_losses.one_hot_targets(jnp.asarray(ids), K)))


# ---- the model ---------------------------------------------------------------

ARCHS = {"kclass_batch": dict(n_classes=K, norm_layer="batch"),
         "kclass_group": dict(n_classes=K, norm_layer="group")}


def _jax_variables(seed, size, **arch):
    """JAX-initialised variables (numpy) with every 1-D parameter and BN
    statistic moved off its init (1s and 0s)."""
    model = JaxUNet3D(base_features=4, remat=False, dtype=jnp.float32, **arch)
    init = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, size, size, size, 5)), train=False))
    variables = jax.device_get(init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def move(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1:
            return (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return np.asarray(a)

    return model, jax.tree_util.tree_map_with_path(move, variables)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_and_label_map_match_jax(arch):
    jmodel, variables = _jax_variables(3, 16, **ARCHS[arch])
    x = np.random.default_rng(7).normal(size=(2, 16, 24, 20, 5)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    want_map = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method=JaxUNet3D.inference))(variables, x))
    model = UNet3D(base_features=4, dtype=torch.float32, **ARCHS[arch]).eval()
    model.load_state_dict(state_dict_from_jax_params(variables["params"], variables.get("batch_stats")), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        probs = model.predict(torch.from_numpy(x)).numpy()
        label_map = model.inference(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape[:4] + (K,) and label_map.shape == x.shape[:4] + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
    assert label_map.dtype == want_map.dtype == np.float32
    _assert_labels_match(label_map[..., 0], want_map[..., 0], np.asarray(jax.nn.softmax(want)), arch)
    norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
    assert len(norms) == (18 if ARCHS[arch]["norm_layer"] == "group" else 0)


# ---- train and eval steps --------------------------------------------------------

STEP_VARIANTS = {
    "kclass_batch_bce_dice": dict(n_classes=K, norm_layer="batch", loss="bce_dice", size=32, eps=1e-2),
    "kclass_group_ds_focal_dice": dict(n_classes=K, norm_layer="group", loss="focal_dice", size=16,
                                       deep_supervision=True, eps=1e-1),
}


def _step_config(variant, for_port):
    kw = dict(STEP_VARIANTS[variant])
    size = kw.pop("size")
    return (get_config if for_port else jax_get_config)(
        base_features=4, remat=False, compute_dtype="float32", conv_lowering="lax", target_size=(size,) * 3,
        learning_rate=LR, weight_decay=1e-2, batch_size=2, **kw)


def _cancelled_bias(model, name):
    """Whether the norm after conv ``name`` cancels its bias: BatchNorm, or
    GroupNorm with one channel per group."""
    if not CONV_BIAS.search(name):
        return False
    seq, idx, _ = name.rsplit(".", 2)
    norm = model.get_submodule(seq)[int(idx) + 1]
    return not isinstance(norm, GroupNorm) or norm.num_channels == norm.num_groups


@pytest.fixture(scope="module", params=sorted(STEP_VARIANTS))
def stepped(request):
    """(variant, JAX state + losses, port model + state + losses, batches)
    after three train steps from the same weights on the same batch."""
    variant = request.param
    config = _step_config(variant, for_port=False)
    size = config.target_size[0]
    jmodel, variables = _jax_variables(0, size, n_classes=K, norm_layer=config.norm_layer,
                                       deep_supervision=config.deep_supervision)
    rng = np.random.default_rng(1)
    batches = []
    for n in (2, 2):
        label = _labels(rng, (n, size, size, size))
        image = rng.normal(size=(n, size, size, size, 5)).astype(np.float32)
        image[..., 0] += label[..., 0]
        batches.append({"image": image, "label": label})
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_steps.TrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
        ema_params={}, tx=jax_steps.make_optimizer(config))
    jmodel = JaxUNet3D.from_config(config)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, config))
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, batches[0])
        jlosses.append(float(m["loss"]))

    port_config = _step_config(variant, for_port=True)
    model = UNet3D.from_config(port_config, deep_supervision=port_config.deep_supervision, device="meta")
    model.load_state_dict(state_dict_from_jax_params(variables["params"], variables.get("batch_stats")),
                          strict=True, assign=True)
    state = steps.create_train_state(model, port_config)
    step = steps.make_train_step(model, port_config)
    tbatch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    plosses = [float(step(state, tbatch)["loss"]) for _ in range(3)]
    return variant, (jmodel, jstate, jlosses), (model, state, plosses), batches


def test_three_steps_match_jax(stepped):
    variant, (_, jstate, jlosses), (model, _, plosses), _ = stepped
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5, err_msg=variant)
    want = state_dict_from_jax_params(jax.device_get(jstate.params),
                                      jstate.batch_stats and jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    for k in [k for k in got if k.endswith("num_batches_tracked")]:
        assert int(got.pop(k)) == 3
        want.pop(k)
    assert sorted(got) == sorted(want)
    if "group" in variant:
        assert not [k for k in got if "running" in k]
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        bound = 2 * LR * 3 if _cancelled_bias(model, k) else ATOL
        assert d.max() <= bound, f"{variant} {k}: {d.max():.3g} > {bound}"


def test_eval_step_matches_jax(stepped):
    """``loss``, per-sample ``dice``/``iou`` (means over classes 1..K−1),
    ``dice_class`` and the uint8 label map, against JAX's eval step on
    JAX's trained state (its weights carried into the port's model), one
    sample masked out by its weight."""
    variant, (jmodel, jstate, _), _, batches = stepped
    config, port_config = _step_config(variant, for_port=False), _step_config(variant, for_port=True)
    batch = dict(batches[1], weight=np.asarray([1.0, 0.0], np.float32))
    want = jax.jit(jax_steps.make_eval_step(jmodel, config, return_pred=True))(jstate, batch)
    model = UNet3D.from_config(port_config, deep_supervision=port_config.deep_supervision, device="meta")
    model.load_state_dict(state_dict_from_jax_params(jax.device_get(jstate.params),
                                                     jstate.batch_stats and jax.device_get(jstate.batch_stats)),
                          strict=True, assign=True)
    got = steps.make_eval_step(model, port_config, return_pred=True)(
        steps.TrainState(model=model, optimizer=None), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-5)
    assert got["dice_class"].shape == (2, K - 1) and got["pred"].dtype == torch.uint8
    for k in ("dice", "iou", "dice_class", "iou_class", "dice_sum", "iou_sum", "weight_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)
    torch.testing.assert_close(got["dice"], got["dice_class"].mean(1))
    logits = np.asarray(jmodel.apply({"params": jstate.params, **({"batch_stats": jstate.batch_stats}
                                                                  if jstate.batch_stats else {})},
                                     batch["image"], train=False))
    _assert_labels_match(got["pred"].numpy()[..., 0], np.asarray(want["pred"])[..., 0],
                         np.asarray(jax.nn.softmax(logits)), f"{variant} eval pred")
    assert set(np.unique(got["pred"].numpy())) <= set(range(K))


# ---- serving -----------------------------------------------------------------------

CASE = (24, 32, 20)  # whole-volume; tiled by 16³ windows


def _write_case(root, shape, modalities, rng):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    blob = np.exp(-4 * (z**2 + y**2 + x**2))
    for i, m in enumerate(modalities):
        os.makedirs(os.path.join(root, m))
        data = 400 * blob * (1 + 0.2 * i) + rng.normal(0, 20, size=shape)
        write_nifti(data.astype(np.int16), os.path.join(root, m, "image.nii.gz"))


def _serving_kw(norm_layer, **kw):
    return dict(base_features=4, remat=False, compute_dtype="float32", target_size=(16, 16, 16),
                n_classes=K, norm_layer=norm_layer, **kw)


@pytest.fixture(scope="module", params=["batch", "group"])
def served(request, tmp_path_factory):
    """(norm_layer, two .pth members exported by the JAX package from
    JAX-initialised states, the case directory, its image). Each member's
    output biases are moved so that its argmax gives every class voxels."""
    norm = request.param
    root = tmp_path_factory.mktemp(f"kclass_serving_{norm}")
    rng = np.random.default_rng(5)
    case = str(root / "inbox" / "case_a")
    jax_config = jax_get_config("quick", **_serving_kw(norm))
    config = get_config("quick", **_serving_kw(norm))
    _write_case(case, CASE, config.modalities, rng)
    paths = []
    for seed in (0, 1):
        model = JaxUNet3D.from_config(jax_config)
        state = jax_steps.create_train_state(jax_config, jax.random.key(seed), model, (1, 16, 16, 16, 5))
        if state.batch_stats:
            state = state.replace(batch_stats=jax.tree_util.tree_map_with_path(
                lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if str(path[-1]) == "['var']"
                                 else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
                jax.device_get(state.batch_stats)))
        pth = str(root / f"member{seed}.pth")
        export_torch_checkpoint(pth, state, meta={"config": jax_config.to_dict()})
        probe = Predictor(config, pth, device="cpu")
        image, _ = probe.load_case(case)
        logp = np.log(np.clip(probe.predict_probs(image), 1e-12, 1.0)).reshape(-1, K)
        sd, snap = load_pth(pth)
        sd["outc.bias"] -= torch.from_numpy(np.median(logp, axis=0).astype(np.float32))
        save_pth(pth, sd, snap)
        paths.append(pth)
    return norm, paths, case, image


@pytest.mark.parametrize("mode", ["ensemble_tta", "tiled"])
def test_label_maps_match_jax(served, mode):
    """Probabilities (K channels, averaged over members, flips and tiles
    before the argmax) and the uint8 label map, against the JAX Predictor
    on the same .pth files. A BatchNorm model is folded, a GroupNorm model
    served unfolded."""
    norm, paths, _, image = served
    kw = _serving_kw(norm, tta=mode != "tiled", **({"window_size": (16, 16, 16)} if mode == "tiled" else {}))
    spec = paths if mode == "ensemble_tta" else paths[0]  # 2 members x 8 flips, or 1 model over 27 tiles
    jax_pred = JaxPredictor(jax_get_config("quick", **kw), spec)
    port = Predictor(get_config("quick", **kw), spec, device="cpu")
    assert len(port.models) == (2 if mode == "ensemble_tta" else 1)
    assert all(m.norm_layer == ("none" if norm == "batch" else "group") for m in port.models)
    want_p = jax_pred.predict_probs(image)
    got_p = port.predict_probs(image)
    assert got_p.shape == want_p.shape == image.shape[:3] + (K,)
    np.testing.assert_allclose(got_p, want_p, atol=PROB_ATOL)
    want, got = jax_pred.predict_mask(image), port.predict_mask(image)
    assert got.dtype == np.uint8 and got.shape == image.shape[:3]
    _assert_labels_match(got, want, want_p, f"{norm} {mode}")
    counts = np.bincount(want.reshape(-1), minlength=K)
    assert (counts > 0.05 * want.size).all(), counts  # every class present


def test_server_writes_uint8_label_maps(served, tmp_path):
    """``PredictionServer.run_once`` writes the Predictor's label map, and
    ``save_prediction`` writes the argmax of given probabilities."""
    norm, paths, case, image = served
    config = get_config("quick", **_serving_kw(norm))
    server = PredictionServer(config, paths[0], os.path.dirname(case), str(tmp_path / "out"), min_age=0.0,
                              device="cpu")
    assert server.run_once()["done"] == 1
    written = read_volume(str(tmp_path / "out" / "case_a" / "segmentation.nii.gz")).data
    want = server.predictor.predict_mask(image)
    assert written.dtype == np.uint8 and np.array_equal(written, want)
    probs = server.predictor.predict_probs(image)
    out = server.predictor.save_prediction(probs, read_volume(os.path.join(case, "ADC", "image.nii.gz")),
                                           str(tmp_path / "saved.nii.gz"))
    np.testing.assert_array_equal(read_volume(out).data, np.argmax(probs, -1).astype(np.uint8))
