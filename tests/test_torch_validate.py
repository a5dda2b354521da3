"""The port's evaluation path against the JAX package's on the CPU: the
Validator (infer/validate.py) in ``validate()`` and ``validate_native()``,
fold ensembles and TTA in the Predictor (infer/predict.py, infer/tta.py),
the postprocess and surface-metric copies, and the ``check`` and
``validate`` verbs.

The checkpoints are the two folds of a short cross-validation run of the
port (base 4, 16³, BCE + Dice, 12 steps at lr 2e-3), each fold's output
bias then set at the 95th percentile of its logits over the cases, so
that its masks hold about 5% of the voxels (the lesions 2.7%), with Dice
0.15-0.45, and fewer than 50 of the 16k voxels lie within 1e-3 of the 0.5
threshold, 1 within 1e-5 (where the packages' fp32 roundings could flip
one). Both
packages score the same ``.pth`` files over the same synthetic cases
(20×18×22 voxels, 1×1×1.5 mm), read through the same ``.npz`` cache. The native grid is tiled by 16³ windows
(8 windows in 2 batches of 4), as the 160×160×144 case is by 128³ ones.
"""

import json
import os

import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.infer import postprocess as jax_postprocess
from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
from pcmseg_tpu.infer.tta import FLIP_SETS as JAX_FLIP_SETS
from pcmseg_tpu.infer.validate import Validator as JaxValidator
from pcmseg_tpu.ops import surface as jax_surface
from pcmseg_tpu.utils.check import generate_report as jax_generate_report
from pcmseg_tpu_torch.cli.main import main
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.infer import postprocess, tta
from pcmseg_tpu_torch.infer.predict import Predictor
from pcmseg_tpu_torch.infer.validate import Validator, load_model_state
from pcmseg_tpu_torch.ops import surface
from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth
from pcmseg_tpu_torch.train.cv import CrossValidationTrainer
from pcmseg_tpu_torch.train.trainer import Trainer
from pcmseg_tpu_torch.utils.check import generate_report

PROB_ATOL = 2e-4  # as tests/test_torch_serving.py: the JAX package's folded-vs-unfolded bound
DICE_ATOL = 2e-3  # per case, the BENCH.md round-5 cross-framework gate
HD95_ATOL = 1.0  # voxels (mm on the native grid, where the finest spacing is 1 mm)
SHAPE = (20, 18, 22)
# each package's config is built from these same arguments
CONFIG_ARGS = dict(base_features=4, remat=False, compute_dtype="float32", target_size=(16, 16, 16),
                   window_size=(16, 16, 16), batch_size=4, surface_metrics=True)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """(data root, the two folds' best .pth paths, a scratch root)."""
    root = tmp_path_factory.mktemp("torch_validate")
    data = str(root / "data")
    make_synthetic_dataset(data, n_cases=4, shape=SHAPE, seed=21)
    config = get_config(data_dir=data, save_dir=str(root / "cv"), cache_dir=str(root / "cache"),
                        base_features=4, remat=False, compute_dtype="float32", target_size=(16, 16, 16),
                        batch_size=1, num_epochs=6, early_stopping=False, n_splits=2, loss="bce_dice",
                        learning_rate=2e-3, seed=0)
    cv = CrossValidationTrainer(config, device="cpu")
    cv.train()
    paths = [os.path.join(config.save_dir, f"best_fold_{k}.pth") for k in range(2)]
    images = torch.from_numpy(np.stack([cv.dataset[i]["image"] for i in range(4)]))
    for path in paths:
        model, state_dict = load_model_state(config, path)
        with torch.no_grad():
            logits = model.eval()(images).numpy()
        sd, snapshot = load_pth(path)
        sd["outc.bias"] -= float(np.quantile(logits, 0.95))
        save_pth(path, sd, snapshot)
    return data, paths, root


def _configs(folds, name, **overrides):
    """(the JAX package's config, the port's) from the same arguments; each
    writes its results into its own directory."""
    data, _, root = folds
    kw = {**CONFIG_ARGS, "data_dir": data, "cache_dir": str(root / "cache"), **overrides}
    return (jax_get_config(save_dir=str(root / name / "jax"), **kw),
            get_config(save_dir=str(root / name / "port"), **kw))


def _assert_results_match(got, want, dice_atol=DICE_ATOL):
    assert sorted(got) == sorted(want)
    assert got["case_count"] == want["case_count"] == 4
    for g, w in zip(got["case_results"], want["case_results"]):
        assert sorted(g) == sorted(w) and g["case_id"] == w["case_id"]
        assert abs(g["dice"] - w["dice"]) <= dice_atol, (g, w)
        assert abs(g["iou"] - w["iou"]) <= dice_atol, (g, w)
        assert g.get("shape") == w.get("shape")
        if "hd95" in w:
            assert (g["hd95"] is None) == (w["hd95"] is None), (g, w)
            if w["hd95"] is not None:
                assert abs(g["hd95"] - w["hd95"]) <= HD95_ATOL, (g, w)
    for k in ("surface_units", "resolution"):
        assert got.get(k) == want.get(k)


def _saved(config, name):
    with open(os.path.join(config.save_dir, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("native", [False, True], ids=["validate", "validate_native"])
def test_single_model_dice_gate(folds, native):
    """One fold's .pth scored by both Validators: per-case |ΔDice| ≤ 2e-3,
    |Δhd95| ≤ 1, the same JSON keys and artifact. ``validate()`` scores
    through the eval step with the unfolded BatchNorm statistics;
    ``validate_native()`` through the folded Predictor, tiled."""
    jax_config, config = _configs(folds, f"single_{native}")
    pth = folds[1][0]
    want = getattr(JaxValidator(jax_config, pth), "validate_native" if native else "validate")()
    got = getattr(Validator(config, pth, device="cpu"), "validate_native" if native else "validate")()
    _assert_results_match(got, want)
    assert got["surface_units"] == ("mm" if native else "voxel")
    assert 0.1 < got["avg_dice"] < 0.9  # the folds learned something, and not everything
    name = "validation_results_native.json" if native else "validation_results.json"
    saved = _saved(config, name)
    assert sorted(saved) == sorted(_saved(jax_config, name))
    assert saved["avg_dice"] == pytest.approx(got["avg_dice"])


@pytest.fixture(scope="module")
def ensemble_validators(folds):
    """Both Validators over the two folds with TTA, largest-component
    postprocessing and surface metrics, after one ``validate()`` each. The
    flip average lies below 0.5 everywhere here, so the threshold is set at
    the 95th percentile of the port's ensemble probabilities (a config
    field both packages read)."""
    _, config = _configs(folds, "ensemble", tta=True)
    probe = Validator(config, folds[1], device="cpu")
    images = np.stack([probe.dataset[i]["image"] for i in range(4)])
    threshold = float(np.quantile(probe._ensemble.predict_probs_batch(images), 0.95))
    jax_config, config = _configs(folds, "ensemble", tta=True, postprocess="largest_cc", threshold=threshold)
    spec = ",".join(folds[1])
    jax_v, port_v = JaxValidator(jax_config, spec), Validator(config, spec, device="cpu")
    return jax_v, port_v, jax_v.validate(), port_v.validate()


def test_ensemble_tta_postprocess_dice_gate(ensemble_validators):
    _, _, want, got = ensemble_validators
    _assert_results_match(got, want)
    assert 0.05 < got["avg_dice"] < 0.9


def test_ensemble_tta_probs_match_jax(ensemble_validators):
    """The ensemble's TTA probabilities on a validation batch, each package
    through its own Validator's Predictor: within PROB_ATOL."""
    jax_v, port_v, _, _ = ensemble_validators
    images = np.stack([port_v.dataset[i]["image"] for i in range(4)])
    want = jax_v._ensemble.predict_probs_batch(images)
    got = port_v._ensemble.predict_probs_batch(images)
    assert got.shape == want.shape == (4, 16, 16, 16, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert 0.02 < (want > port_v.config.threshold).mean() < 0.98


def test_ensemble_is_the_mean_of_its_members(folds):
    _, config = _configs(folds, "members")
    image = np.random.default_rng(3).normal(size=SHAPE + (5,)).astype(np.float32)
    members = [Predictor(config, p, device="cpu").predict_probs(image) for p in folds[1]]
    ensemble = Predictor(config, folds[1], device="cpu")
    assert len(ensemble.models) == 2
    assert np.abs(members[0] - members[1]).max() > 1e-3  # the folds differ
    np.testing.assert_allclose(ensemble.predict_probs(image), (members[0] + members[1]) / 2, atol=1e-6)
    glob = Predictor(config, os.path.join(os.path.dirname(folds[1][0]), "best_fold_*.pth"), device="cpu")
    np.testing.assert_array_equal(glob.predict_probs(image), ensemble.predict_probs(image))


def test_flip_sets_match_jax():
    assert tta.FLIP_SETS == JAX_FLIP_SETS and len(set(tta.FLIP_SETS)) == 8


def test_tta_is_the_flip_average():
    """The flip ensemble of an orientation-sensitive apply equals the
    explicit flip / un-flip average (mirrors tests/test_tta.py)."""
    x = np.random.default_rng(0).random((2, 4, 5, 6, 3)).astype(np.float32)
    ramp = np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1, 1)
    got = tta.make_tta_apply(lambda t: t[..., :1] * torch.from_numpy(ramp))(torch.from_numpy(x)).numpy()
    want = np.zeros_like(x[..., :1])
    for axes in JAX_FLIP_SETS:
        p = (np.flip(x, axes) if axes else x)[..., :1] * ramp
        want += np.flip(p, axes) if axes else p
    np.testing.assert_allclose(got, want / 8.0, rtol=1e-6)


def test_tta_predictor_is_flip_invariant(folds):
    """TTA through the Predictor, whole-volume and tiled: flipping the
    input flips the output, up to fp32 rounding."""
    _, config = _configs(folds, "tta", tta=True)
    predictor = Predictor(config, folds[1][0], device="cpu")
    image = np.random.default_rng(4).normal(size=SHAPE + (5,)).astype(np.float32)
    for x in (image, image[:16, :16, :16]):  # tiled, then one window
        base = predictor.predict_probs(x)
        for axis in (0, 1, 2):
            flipped = predictor.predict_probs(np.ascontiguousarray(np.flip(x, axis)))
            np.testing.assert_allclose(np.flip(flipped, axis), base, atol=1e-5)


def test_tiled_ensemble_tta_matches_jax(folds):
    """The tiled path with an ensemble and TTA, on one native-grid volume:
    each tile batch goes through the flip ensemble of the fold mean."""
    jax_config, config = _configs(folds, "tiled", tta=True)
    image = np.random.default_rng(5).normal(size=SHAPE + (5,)).astype(np.float32)
    want = JaxPredictor(jax_config, folds[1]).predict_probs(image)
    got = Predictor(config, folds[1], device="cpu").predict_probs(image)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


def test_predict_mask_and_save_prediction_postprocess(folds, tmp_path):
    _, config = _configs(folds, "post", postprocess="largest_cc", min_component_voxels=3)
    predictor = Predictor(config, folds[1][0], device="cpu")
    image = np.random.default_rng(6).normal(size=SHAPE + (5,)).astype(np.float32)
    probs = predictor.predict_probs(image)
    want = jax_postprocess.postprocess_mask((probs[..., 0] > 0.5).astype(np.uint8), "largest_cc", 3)
    np.testing.assert_array_equal(predictor.predict_mask(image), want)
    from pcmseg_tpu_torch.data.io import read_volume
    from pcmseg_tpu_torch.data.volume import Volume

    out = predictor.save_prediction(probs, Volume(image[..., 0]), str(tmp_path / "seg.nii.gz"))
    np.testing.assert_array_equal(read_volume(out).data, want)


# ---- the copies of postprocess and surface metrics ---------------------------


def _masks():
    rng = np.random.default_rng(8)
    blobs = (rng.random((14, 12, 16)) > 0.7).astype(np.uint8)
    cube = np.zeros((14, 12, 16), np.uint8)
    cube[3:9, 2:8, 4:12] = 1
    shifted = np.roll(cube, 2, axis=0)
    plane_a, plane_b = np.zeros_like(cube), np.zeros_like(cube)
    plane_a[4], plane_b[9] = 1, 1
    return {
        "blobs": (blobs, cube), "shifted": (cube, shifted), "planes": (plane_a, plane_b),
        "same": (cube, cube), "one_empty": (cube, np.zeros_like(cube)),
        "both_empty": (np.zeros_like(cube), np.zeros_like(cube)),
        "channel_dim": (blobs[..., None], shifted.astype(np.float32)[..., None]),
    }


@pytest.mark.parametrize("name", sorted(_masks()))
@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (1.5, 0.7, 0.7)])
def test_surface_metrics_match(name, spacing):
    pred, target = _masks()[name]
    for a, b in zip(surface.surface_distances(pred, target, spacing),
                    jax_surface.surface_distances(pred, target, spacing)):
        np.testing.assert_array_equal(a, b)
    for fn, kw in (("hausdorff_distance", {"percentile": 95.0}), ("hausdorff_distance", {"percentile": 100.0}),
                   ("assd", {}), ("surface_dice", {"tolerance": 1.0})):
        assert getattr(surface, fn)(pred, target, spacing, **kw) == getattr(jax_surface, fn)(pred, target, spacing, **kw)
    assert surface.case_surface_metrics(pred, target, spacing, 95.0, 2.0) == \
        jax_surface.case_surface_metrics(pred, target, spacing, 95.0, 2.0)


def test_surface_rejects_what_jax_rejects():
    for mod in (surface, jax_surface):
        with pytest.raises(ValueError):
            mod.surface_distances(np.zeros((4, 4)), np.zeros((4, 4)))


@pytest.mark.parametrize("name", ["blobs", "shifted", "one_empty", "both_empty"])
@pytest.mark.parametrize("mode,min_voxels,connectivity", [
    ("largest_cc", 0, 1), ("none", 4, 1), ("largest_cc", 6, 1), ("largest_cc", 0, 3), ("none", 0, 1),
])
def test_postprocess_matches(name, mode, min_voxels, connectivity):
    mask = _masks()[name][0]
    got = postprocess.postprocess_mask(mask, mode, min_voxels, connectivity)
    want = jax_postprocess.postprocess_mask(mask, mode, min_voxels, connectivity)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    labels = (mask * np.random.default_rng(9).integers(1, 4, size=mask.shape)).astype(np.uint8)
    np.testing.assert_array_equal(postprocess.postprocess_labelmap(labels, mode, min_voxels, connectivity),
                                  jax_postprocess.postprocess_labelmap(labels, mode, min_voxels, connectivity))
    for kw in (dict(postprocess=mode, min_component_voxels=min_voxels),
               dict(postprocess=mode, min_component_voxels=min_voxels, n_classes=3)):
        np.testing.assert_array_equal(
            postprocess.postprocess_from_config(labels, get_config(**kw)),
            jax_postprocess.postprocess_from_config(labels, jax_get_config(**kw)),
        )
    with pytest.raises(ValueError):
        postprocess.postprocess_mask(mask, "bogus")


# ---- refusals, the EMA checkpoint, the verbs ------------------------------------


def test_validator_refuses_k_class(folds, tmp_path):
    """K-class validation, ported since (tests/test_torch_groupnorm.py holds
    a trained K = 3 cohort against JAX): fold 1's BatchNorm model with a
    3-class head grafted on (logits 0, z and z/2 + 1 for its binary logit z)
    is scored through the eval step by both Validators, per class within the
    Dice gate; each case's ``dice`` is the mean of its classes."""
    sd, snapshot = load_pth(folds[1][0])
    w, b = sd["outc.weight"], sd["outc.bias"]
    sd["outc.weight"] = torch.cat([torch.zeros_like(w), w, 0.5 * w])
    sd["outc.bias"] = torch.cat([torch.zeros_like(b), b, 0.5 * b + 1.0])
    pth = save_pth(str(tmp_path / "kclass.pth"), sd, {**snapshot, "n_classes": 3})
    jax_config, config = _configs(folds, "kclass")
    assert Validator(config, pth, device="cpu").config.n_classes == 3  # adopted from the snapshot
    want = JaxValidator(jax_config, pth).validate()
    got = Validator(config, pth, device="cpu").validate()
    _assert_results_match(got, want)
    assert sorted(got["avg_dice_per_class"]) == ["1", "2"]
    for g, wr in zip(got["case_results"], want["case_results"]):
        for c in ("1", "2"):
            assert abs(g["dice_per_class"][c] - wr["dice_per_class"][c]) <= DICE_ATOL, (c, g, wr)
        assert g["dice"] == pytest.approx(np.mean(list(g["dice_per_class"].values())))


def test_ema_checkpoint_is_scored_with_its_own_weights(folds, tmp_path):
    """An EMA run's best.pth holds the averaged weights; the port's Validator
    scores them whatever the adopted ``ema_decay`` says. (The JAX Validator
    scores a .pth of an EMA run with its freshly initialised EMA instead:
    ROADMAP queue C.)"""
    data, _, root = folds
    config = get_config(data_dir=data, save_dir=str(tmp_path), cache_dir=str(root / "cache"), base_features=4,
                        compute_dtype="float32", target_size=(16, 16, 16), batch_size=2, num_epochs=2,
                        ema_decay=0.9, learning_rate=1e-2, early_stopping=False, seed=1)
    Trainer(config, device="cpu").train()
    pth = os.path.join(str(tmp_path), "best.pth")
    adopted = Validator(get_config(data_dir=data, cache_dir=config.cache_dir, save_dir=str(tmp_path)), pth,
                        device="cpu")
    assert adopted.config.ema_decay == 0.9
    off = Validator(adopted.config.replace(ema_decay=0.0), pth, explicit=["ema_decay"], device="cpu")
    assert adopted.validate(save=False)["case_results"] == off.validate(save=False)["case_results"]


def test_check_report_matches_jax_keys(folds, tmp_path, capsys, monkeypatch):
    data, paths, _ = folds
    save_dir = os.path.dirname(paths[0])
    out = str(tmp_path / "report.json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["check", "--data_dir", data, "--save_dir", save_dir, "--output", out]) == 1  # no card
    assert main(["check", "--data_dir", data, "--save_dir", save_dir, "--output", out, "--device", "cpu"]) == 0
    assert "devices: 0 (cpu)" in capsys.readouterr().out
    with open(out) as f:
        got = json.load(f)
    want = jax_generate_report(data_dir=data, save_dir=save_dir, output_path=None)
    assert sorted(got) == sorted(want)
    for section in ("dependencies", "data", "checkpoints", "files"):
        assert sorted(got[section]) == sorted(want[section]), section
    assert {"ok", "backend", "device_count", "devices"} <= set(got["devices"])
    assert got["data"] == want["data"] and got["ok"] and got["files"]["ok"]
    assert {"best_fold_0.pth", "best_fold_1.pth", "latest_fold_0.pt"} <= set(got["checkpoints"]["checkpoints"])
    report = generate_report(data_dir=data, save_dir=save_dir, output_path=None)
    assert report["devices"] == {"ok": False, "backend": "cuda", "device_count": 0, "devices": []}
    assert not report["ok"]


def test_cli_validate(folds, tmp_path, capsys, monkeypatch):
    """``validate`` scores a glob of fold checkpoints, whole and native; it
    fails without a card unless given ``--device cpu``."""
    data, paths, root = folds
    argv = ["validate", "--data_dir", data, "--model_path", os.path.join(os.path.dirname(paths[0]), "best_fold_*.pth"),
            "--save_dir", str(tmp_path), "--cache_dir", str(root / "cache"),
            "--tta", "--batch_size", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) != 0
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Validator(get_config(data_dir=data), paths[0])
    assert main(argv + ["--device", "cpu"]) == 0
    assert "(4 cases)" in capsys.readouterr().out
    assert main(argv + ["--device", "cpu", "--native", "--surface_metrics"]) == 0
    assert _saved(get_config(save_dir=str(tmp_path)), "validation_results_native.json")["surface_units"] == "mm"
