"""Port's trainer and ``train`` verb (train/trainer.py, cli/main.py) on the CPU:
the loss history against the JAX ``Trainer`` from the same weights, kill
and resume, the checkpoints and ``.pth`` that ``predict`` serves, and the
options the port refuses."""

import os

import jax
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.train.trainer import Trainer as JaxTrainer
from pcmseg_tpu_torch.cli.main import main
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.infer.predict import Predictor
from pcmseg_tpu_torch.train.checkpoints import load_pth, state_dict_from_jax_params
from pcmseg_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=5, shape=(34, 32, 30), seed=7)
    return root


def _config(tree, tmp_path, for_jax=False, **kw):
    """The port's config (the JAX package's with ``for_jax=True``), from the
    same arguments."""
    base = dict(
        data_dir=tree, save_dir=str(tmp_path / "ckpt"), cache_dir=str(tmp_path / "cache"),
        base_features=4, compute_dtype="float32", remat=False, conv_lowering="lax",
        target_size=(32, 32, 32), batch_size=2, num_epochs=2, early_stopping=False,
        data_parallel=1, device_data_cache_gb=0.0, seed=3, learning_rate=1e-3,
    )
    base.update(kw)
    return (jax_get_config if for_jax else get_config)(**base)


def test_history_matches_jax_trainer(tree, tmp_path):
    """Two epochs (4 train cases in 2 steps, 1 val case padded to 2) from
    the same weights: the losses agree to 1e-4. The optimizer is the
    config's own (Adam 1e-4, eps 1e-8, coupled L2 1e-5, clip 1.0). The
    elements whose gradient is fp32 noise move by ±lr in both packages,
    differently, so the losses part by about lr: 3.5e-6 measured at lr 1e-4
    (1.5e-4 at lr 1e-3). Val Dice/IoU count thresholded voxels of one 32³
    case, where a voxel whose probability sits within rounding of 0.5
    flips: atol 2e-3 (a few voxels)."""
    config = _config(tree, tmp_path, learning_rate=1e-4)
    jax_trainer = JaxTrainer(_config(tree, tmp_path, for_jax=True, learning_rate=1e-4, save_dir=str(tmp_path / "jax")))
    trainer = Trainer(config, device="cpu")
    assert trainer.train_indices == jax_trainer.train_indices
    assert trainer.val_indices == jax_trainer.val_indices and len(trainer.val_indices) == 1
    trainer.state.model.load_state_dict(
        state_dict_from_jax_params(
            jax.device_get(jax_trainer.state.params), jax.device_get(jax_trainer.state.batch_stats)
        )
    )
    want, got = jax_trainer.train(), trainer.train()
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 2e-3 if k in ("val_dice", "val_iou") else 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def test_kill_after_epoch_one_and_resume_is_bitwise(tree, tmp_path):
    whole = Trainer(_config(tree, tmp_path / "a"), device="cpu")
    history = whole.train()
    killed = _config(tree, tmp_path / "b", num_epochs=1)
    Trainer(killed, device="cpu").train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device="cpu")
    assert resumed.start_epoch == 1 and resumed.train_loader._epoch == 1
    assert resumed.train() == history
    for (k, a), b in zip(whole.state.model.state_dict().items(), resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(whole.state.optimizer.state.values(), resumed.state.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_cli_train_writes_checkpoints_that_predict_serves(tree, tmp_path):
    save = str(tmp_path / "ckpt")
    rc = main(["train", "--data_dir", tree, "--save_dir", save, "--epochs", "2",
               "--target_size", "16", "16", "16", "--base_features", "4", "--batch_size", "2",
               "--cache_dir", str(tmp_path / "cache"), "--learning_rate", "1e-3", "--device", "cpu"])
    assert rc == 0
    for name in ("latest.pt", "best.pt", "best.pth"):
        assert os.path.isfile(os.path.join(save, name)), name
    sd, snapshot = load_pth(os.path.join(save, "best.pth"))
    assert snapshot["base_features"] == 4 and "inc.conv.1.running_var" in sd
    ckpt = torch.load(os.path.join(save, "latest.pt"), weights_only=True)
    assert ckpt["step"] == 4 and ckpt["meta"]["epoch"] == 1 and len(ckpt["meta"]["history"]["train_loss"]) == 2
    predictor = Predictor(get_config(), os.path.join(save, "best.pth"), device="cpu")
    mask = predictor.predict_mask(np.random.default_rng(0).normal(size=(16, 16, 16, 5)).astype(np.float32))
    assert mask.shape == (16, 16, 16) and mask.dtype == np.uint8


def test_periodic_checkpoints_are_pruned(tree, tmp_path):
    config = _config(tree, tmp_path, target_size=(16, 16, 16), num_epochs=3, save_frequency=1,
                     keep_checkpoints=2, validation=False)
    Trainer(config, device="cpu").train()
    assert sorted(f for f in os.listdir(config.save_dir) if f.startswith("epoch_")) == ["epoch_2.pt", "epoch_3.pt"]


@pytest.mark.parametrize(
    "option",
    [dict(data_parallel=2), dict(spatial_parallel=2), dict(tensor_parallel=2), dict(async_checkpoint=True),
     dict(profile_dir="prof"), dict(n_classes=3), dict(deep_supervision=True), dict(norm_layer="group")],
    ids=lambda o: next(iter(o)),
)
def test_unported_options_are_refused_by_name(tree, tmp_path, option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        Trainer(_config(tree, tmp_path, **option), device="cpu")


def test_cli_refuses_cross_validation(tree, capsys):
    assert main(["train", "--data_dir", tree, "--cross_validation"]) != 0
    assert "cross_validation" in capsys.readouterr().err


def test_ema_weights_are_served_and_restored_on_resume(tree, tmp_path):
    """With EMA on, validation and best.pth use the averaged weights, and a
    resume restores the EMA bit for bit."""
    config = _config(tree, tmp_path, target_size=(16, 16, 16), ema_decay=0.9, num_epochs=1)
    trainer = Trainer(config, device="cpu")
    trainer.train()
    sd, _ = load_pth(os.path.join(config.save_dir, "best.pth"))
    w = "inc.conv.0.weight"
    assert torch.equal(sd[w], trainer.state.ema[w]) and not torch.equal(sd[w], trainer.state.model.state_dict()[w])
    resumed = Trainer(config.replace(resume=True), device="cpu")
    for k, v in trainer.state.ema.items():
        assert torch.equal(v, resumed.state.ema[k]), k
    assert resumed.state.step == trainer.state.step == 2


def test_loader_errors_reach_the_training_loop(tree, tmp_path):
    trainer = Trainer(_config(tree, tmp_path, target_size=(16, 16, 16), validation=False), device="cpu")

    def broken(i):
        raise OSError(f"cannot read case {i}")

    trainer.dataset.load_case = broken
    with pytest.raises(OSError, match="cannot read case"):
        trainer.train_epoch()


def test_trainer_without_a_device_needs_cuda(tree, tmp_path, monkeypatch, capsys):
    """No entry point falls back to the CPU on its own: without a card the
    Trainer and the ``train`` verb raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config(tree, tmp_path, target_size=(16, 16, 16), validation=False, num_epochs=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(config)
    assert main(["train", "--data_dir", tree, "--save_dir", str(tmp_path / "cli"), "--epochs", "1",
                 "--target_size", "16", "16", "16", "--base_features", "4"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert Trainer(config, device="cpu").device == torch.device("cpu")
