"""The port's cross-validation trainer (train/cv.py) and the Trainer's fold
arguments (train/trainer.py) on the CPU: a 2-fold × 1-epoch run against the
JAX ``CrossValidationTrainer`` from the same weights, the fold files and
``cv_results.json``, the completed-fold skip on resume, the ``train
--cross_validation`` and ``export`` verbs."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train.cv import CrossValidationTrainer as JaxCrossValidationTrainer
from pcmseg_tpu.train.steps import create_train_state
from pcmseg_tpu_torch.cli.main import main
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.infer.predict import Predictor
from pcmseg_tpu_torch.train import cv
from pcmseg_tpu_torch.train.checkpoints import load_pth, state_dict_from_jax_params
from pcmseg_tpu_torch.train.cv import CrossValidationTrainer
from pcmseg_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cv_data"))
    make_synthetic_dataset(root, n_cases=5, shape=(34, 32, 30), seed=11)
    return root


def _config(tree, save_dir, for_jax=False, **kw):
    """The port's config (the JAX package's with ``for_jax=True``), from the
    same arguments."""
    base = dict(
        data_dir=tree, save_dir=str(save_dir), cache_dir=str(save_dir) + "_cache",
        base_features=4, compute_dtype="float32", remat=False, conv_lowering="lax",
        target_size=(32, 32, 32), batch_size=2, num_epochs=1, early_stopping=False,
        data_parallel=1, device_data_cache_gb=0.0, seed=3, learning_rate=1e-4, n_splits=2,
    )
    base.update(kw)
    return (jax_get_config if for_jax else get_config)(**base)


def test_cross_validation_matches_jax(tree, tmp_path, monkeypatch):
    """2 folds × 1 epoch from the JAX folds' own initial weights (every fold
    starts from ``config.seed``): the same splits, each fold's history
    within the trainer test's tolerances (losses 1e-4; thresholded Dice/IoU
    of a few val cases 2e-3), the same fold files (JAX checkpoint
    directories are the port's ``.pt`` files) and ``cv_results.json``."""
    jax_config = _config(tree, tmp_path / "jax", for_jax=True)
    config = _config(tree, tmp_path / "port")
    state = create_train_state(
        jax_config, jax.random.key(jax_config.seed), JaxUNet3D.from_config(jax_config), (1, 32, 32, 32, 5)
    )
    init = state_dict_from_jax_params(jax.device_get(state.params), jax.device_get(state.batch_stats))

    class FromJaxInit(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.state.model.load_state_dict(init)

    monkeypatch.setattr(cv, "Trainer", FromJaxInit)
    jax_cv = JaxCrossValidationTrainer(jax_config)
    port_cv = CrossValidationTrainer(config, device="cpu")
    for (tr, va), (jtr, jva) in zip(port_cv.splits, jax_cv.splits):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(va, jva)
    want, got = jax_cv.train(), port_cv.train()

    assert sorted(got) == sorted(want) == ["config", "fold_results", "summary"]
    assert got["config"] == want["config"] | {"save_dir": config.save_dir, "cache_dir": config.cache_dir}
    assert sorted(got["summary"]) == sorted(want["summary"])
    assert got["summary"]["total_folds"] == want["summary"]["total_folds"] == 2
    for k in ("mean_val_loss", "std_val_loss"):
        np.testing.assert_allclose(got["summary"][k], want["summary"][k], atol=1e-4, err_msg=k)
    for g, w in zip(got["fold_results"], want["fold_results"]):
        assert sorted(g) == sorted(w) and g["fold"] == w["fold"] and g["epochs_trained"] == w["epochs_trained"] == 1
        np.testing.assert_allclose(g["best_val_loss"], w["best_val_loss"], atol=1e-4)
    for k in range(2):
        with open(tmp_path / "jax" / f"fold_{k}_history.json") as f:
            w = json.load(f)
        with open(tmp_path / "port" / f"fold_{k}_history.json") as f:
            g = json.load(f)
        assert sorted(g) == sorted(w)
        for key in w:
            atol = 2e-3 if key in ("val_dice", "val_iou") else 1e-4
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol, err_msg=f"fold {k} {key}")

    def stems(d):
        return sorted(os.path.splitext(n)[0] for n in os.listdir(d) if not n.startswith("."))

    port_files = stems(tmp_path / "port")
    assert sorted(set(port_files)) == stems(tmp_path / "jax")
    for k in range(2):  # the reference-layout export of each fold's best model
        assert os.path.isfile(tmp_path / "port" / f"best_fold_{k}.pth")


def test_resume_skips_completed_folds(tree, tmp_path, monkeypatch):
    """A CV restart after a kill during fold 1 (its history marker gone,
    its latest checkpoint set back to epoch 0): fold 0 is skipped without
    building a Trainer and its files stay untouched; fold 1 resumes from
    ``latest_fold_1`` and finishes with the first epoch as it was."""
    config = _config(tree, tmp_path / "cv", target_size=(16, 16, 16), num_epochs=2)
    first = CrossValidationTrainer(config, device="cpu").train()
    save = config.save_dir
    with open(os.path.join(save, "fold_1_history.json")) as f:
        full = json.load(f)
    os.remove(os.path.join(save, "fold_1_history.json"))
    os.remove(os.path.join(save, "cv_results.json"))
    latest = os.path.join(save, "latest_fold_1.pt")
    payload = torch.load(latest, weights_only=True)
    payload["meta"]["epoch"] = 0
    payload["meta"]["history"] = {k: v[:1] for k, v in payload["meta"]["history"].items()}
    torch.save(payload, latest)
    best0 = os.path.join(save, "best_fold_0.pt")
    mtime = os.path.getmtime(best0)

    built = []

    class Counted(Trainer):
        def __init__(self, *args, **kwargs):
            built.append(kwargs["tag"])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(cv, "Trainer", Counted)
    second = CrossValidationTrainer(config.replace(resume=True), device="cpu").train()
    assert built == ["fold_1"]
    assert os.path.getmtime(best0) == mtime
    assert second["fold_results"][0] == first["fold_results"][0]
    with open(os.path.join(save, "fold_1_history.json")) as f:
        again = json.load(f)
    assert len(again["train_loss"]) == 2 and again["train_loss"][0] == full["train_loss"][0]
    assert second["summary"]["total_folds"] == 2
    assert os.path.exists(os.path.join(save, "cv_results.json"))


@pytest.mark.parametrize(
    "history,num_epochs,early_stopping,complete",
    [
        ({"train_loss": [1.0, 0.9], "val_loss": [1.1, 1.0]}, 2, False, True),
        ({"train_loss": [1.0], "val_loss": [1.1]}, 2, False, False),  # extended run: re-enter
        ({"train_loss": [1.0], "val_loss": [1.1]}, 2, True, True),  # stopped early: done
        ({"train_loss": [], "val_loss": []}, 2, False, False),
        (None, 2, False, False),  # truncated marker
    ],
)
def test_completed_fold_marker(tree, tmp_path, history, num_epochs, early_stopping, complete):
    config = _config(tree, tmp_path, num_epochs=num_epochs, early_stopping=early_stopping)
    with open(tmp_path / "fold_0_history.json", "w") as f:
        f.write(json.dumps(history) if history is not None else '{"train_loss": [1.')
    done = CrossValidationTrainer(config, device="cpu")._completed_fold_result(0)
    if not complete:
        assert done is None
    else:
        assert done == {"fold": 1, "best_val_loss": min(history["val_loss"]),
                        "epochs_trained": len(history["train_loss"])}


def test_fold_arguments_and_tagged_checkpoints(tree, tmp_path):
    """``val_indices`` alone trains on the rest; under a tag every
    checkpoint is ``{name}_{tag}``, pruning keeps to its own tag, and a
    resume under the tag reads ``latest_{tag}``."""
    config = _config(tree, tmp_path, target_size=(16, 16, 16), num_epochs=2, save_frequency=1,
                     keep_checkpoints=1)
    open(os.path.join(tmp_path, "epoch_1.pt"), "w").close()  # another run's: not pruned
    trainer = Trainer(config, val_indices=[1, 3], tag="fold_7", device="cpu")
    assert trainer.train_indices == [0, 2, 4] and trainer.val_indices == [1, 3]
    trainer.train()
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith((".pt", ".pth")))
    assert names == ["best_fold_7.pt", "best_fold_7.pth", "epoch_1.pt", "epoch_2_fold_7.pt", "latest_fold_7.pt"]
    ckpt = torch.load(tmp_path / "latest_fold_7.pt", weights_only=True)
    assert ckpt["meta"]["tag"] == "fold_7" and ckpt["meta"]["epoch"] == 1
    resumed = Trainer(config.replace(num_epochs=3, resume=True), val_indices=[1, 3], tag="fold_7", device="cpu")
    assert resumed.start_epoch == 2
    untagged = Trainer(config.replace(resume=True), device="cpu")
    assert untagged.start_epoch == 0  # no latest.pt: a fresh start


def test_cli_cross_validation_and_export(tree, tmp_path, capsys):
    """``train --cross_validation`` runs the port's CrossValidationTrainer;
    its fold models serve as an ensemble; ``export`` turns a fold's ``.pt``
    into the ``.pth`` it wrote itself, with the JAX export's meta keys."""
    save = str(tmp_path / "ckpt")
    argv = ["train", "--cross_validation", "--n_splits", "2", "--data_dir", tree, "--save_dir", save,
            "--epochs", "1", "--target_size", "16", "16", "16", "--base_features", "4",
            "--batch_size", "2", "--cache_dir", str(tmp_path / "cache")]
    assert main(argv) != 0  # without a card, only with --device cpu
    assert "--device cpu" in capsys.readouterr().err
    assert main(argv + ["--device", "cpu"]) == 0
    assert "cross-validation: 2 folds" in capsys.readouterr().out
    for name in ("cv_results.json", "fold_0_history.json", "fold_1_history.json", "best_fold_0.pth",
                 "best_fold_1.pth", "latest_fold_0.pt", "latest_fold_1.pt"):
        assert os.path.isfile(os.path.join(save, name)), name
    predictor = Predictor(get_config(), os.path.join(save, "best_fold_*.pth"), device="cpu")
    assert len(predictor.models) == 2

    out = str(tmp_path / "exported" / "fold0.pth")
    export = ["export", "--model_path", os.path.join(save, "best_fold_0.pt"), "--output", out]
    assert main(export) != 0
    assert main(export + ["--device", "cpu"]) == 0
    got, snapshot = load_pth(out)
    want, _ = load_pth(os.path.join(save, "best_fold_0.pth"))
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    payload = torch.load(out, weights_only=True)
    assert {"exported_from", "epoch", "monitor", "best_monitor", "config"} <= set(payload)
    assert snapshot["base_features"] == 4 and payload["epoch"] == 0
    assert main(["export", "--model_path", os.path.join(save, "best_fold_0.pth"), "--output", out,
                 "--device", "cpu"]) != 0  # a .pth is already an export
