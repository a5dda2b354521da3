"""The port's profiling hooks (pcmseg_tpu_torch/utils/profiling.py) on the CPU:
the three tests of tests/test_profiling.py on ``torch.profiler``, the window
each package's StepTraceController opens on the same schedule, a trainer
whose trace holds its step's ops, and a server whose ``close()`` writes a
window shorter than ``profile_steps``."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import pcmseg_tpu.utils.profiling as jax_profiling
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu_torch.cli.main import main as torch_main
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data.nifti import write_nifti
from pcmseg_tpu_torch.infer.serve import PredictionServer
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train.checkpoints import save_pth
from pcmseg_tpu_torch.train.trainer import Trainer
from pcmseg_tpu_torch.utils import profiling
from pcmseg_tpu_torch.utils.profiling import StepTraceController, annotate, device_memory_report, trace


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trace_events(log_dir):
    """The events of the one trace file under ``log_dir``."""
    files = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [e for e in json.load(f)["traceEvents"] if isinstance(e, dict)]


def _spans(events, prefix):
    return [e["name"] for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]


def test_step_trace_controller_writes_dump(tmp_path):
    c = StepTraceController(str(tmp_path), "cpu", start_step=1, n_steps=2)
    for i in range(5):
        c.on_step(i)
        with annotate(f"step{i}"):
            (torch.ones(8) * 2.0).sum()
    c.close()
    dumped = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert dumped, "no profiler dump written"
    assert _spans(_trace_events(tmp_path), "step") == ["step1", "step2"]


def test_trace_controller_none_is_noop():
    c = StepTraceController(None, "cpu")
    for i in range(3):
        c.on_step(i)
    c.close()  # must not raise
    with trace(None, "cpu"):
        pass


def test_trace_survives_epochs_shorter_than_start_step(tmp_path):
    """One-step epochs (tiny datasets) + per-epoch close() must still
    capture a window in a later epoch, not disarm silently."""
    c = StepTraceController(str(tmp_path), "cpu", start_step=1, n_steps=1)
    for _epoch in range(4):  # each epoch: ONE step then close()
        c.on_step(0)
        (torch.ones(4) + 1.0).sum()
        c.close()
    dumped = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert dumped, "profiler dump lost to the short-epoch latch"


@pytest.mark.parametrize(
    "start_step,n_steps,epochs",
    [(1, 2, [5]), (1, 5, [2, 2, 2]), (0, 3, [2, 2]), (1, 1, [1, 1, 1, 1]), (2, 2, [1, 1, 1, 1])],
)
def test_window_matches_jax(monkeypatch, start_step, n_steps, epochs):
    """Over the same epochs (steps per epoch, close() at each end), both
    packages' controllers open and close their window at the same steps."""
    events = {"jax": [], "torch": []}
    clock = {"step": 0}
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: events["jax"].append(("start", clock["step"])))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: events["jax"].append(("stop", clock["step"])))
    monkeypatch.setattr(profiling, "_start", lambda d, dev: events["torch"].append(("start", clock["step"])) or 1)
    monkeypatch.setattr(profiling, "_stop", lambda p, dev: events["torch"].append(("stop", clock["step"])))
    controllers = [
        jax_profiling.StepTraceController("dir", start_step=start_step, n_steps=n_steps),
        StepTraceController("dir", "cpu", start_step=start_step, n_steps=n_steps),
    ]
    for steps in epochs:
        for i in range(steps):
            for c in controllers:
                c.on_step(i)
            clock["step"] += 1
        for c in controllers:
            c.close()
    assert events["torch"] == events["jax"] and events["jax"][0][0] == "start"


def test_device_memory_report_prints_nothing_on_the_cpu(capsys):
    with device_memory_report("cpu"):
        torch.ones(4).sum()
    with device_memory_report([torch.device("cpu")]):
        pass
    assert capsys.readouterr().out == ""


def test_trainer_trace_holds_its_steps(tmp_path):
    """A 1-epoch CPU trainer of 3 one-case steps with ``profile_dir`` and
    ``profile_steps=1``: one trace, of step 1, whose ops are the step's own
    (the convs' plain versions forward and backward, Adam)."""
    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_cases=3, shape=(16, 16, 16), seed=2)
    config = get_config(
        data_dir=data, save_dir=str(tmp_path / "ckpt"), base_features=4, compute_dtype="float32",
        remat=False, target_size=(16, 16, 16), batch_size=1, num_epochs=1, validation=False,
        device_data_cache_gb=0.0, profile_dir=str(tmp_path / "prof"), profile_steps=1,
    )
    trainer = Trainer(config, device="cpu")
    trainer.train()
    names = {e["name"] for e in _trace_events(tmp_path / "prof") if e.get("cat") == "cpu_op"}
    assert {"aten::convolution", "aten::convolution_backward"} <= names
    assert any("Adam" in n for n in {e["name"] for e in _trace_events(tmp_path / "prof")})


def _serve_tree(root, config, n_cases):
    rng = np.random.default_rng(0)
    for c in range(n_cases):
        for m in config.modalities:
            os.makedirs(os.path.join(root, f"case_{c}", m))
            data = rng.normal(100, 20, size=(16, 16, 16)).astype(np.int16)
            write_nifti(data, os.path.join(root, f"case_{c}", m, "image.nii.gz"))


def test_server_close_writes_a_short_window(tmp_path):
    """``profile_steps`` 5 and 2 cases: the window is open after run_once
    and written by close(), with one ``case:`` span per case."""
    config = get_config(base_features=4, profile_dir=str(tmp_path / "prof"), profile_steps=5)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0))
    pth = save_pth(str(tmp_path / "m.pth"), model.state_dict(), config.to_dict())
    _serve_tree(str(tmp_path / "in"), config, 2)
    server = PredictionServer(config, pth, str(tmp_path / "in"), str(tmp_path / "out"), min_age=0.0,
                              explicit=["profile_dir", "profile_steps"], device="cpu")
    assert server.run_once()["done"] == 2
    assert not glob.glob(str(tmp_path / "prof" / "*.json"))
    server.close()
    assert sorted(_spans(_trace_events(tmp_path / "prof"), "case:")) == ["case:case_0", "case:case_1"]
    server.close()  # idempotent


def test_cli_predict_writes_a_trace(tmp_path):
    config = get_config(base_features=4)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0))
    pth = save_pth(str(tmp_path / "m.pth"), model.state_dict(), config.to_dict())
    _serve_tree(str(tmp_path / "in"), config, 1)
    argv = ["predict", "--model_path", pth, "--input_dir", str(tmp_path / "in" / "case_0"), "--output_dir",
            str(tmp_path / "out"), "--profile", str(tmp_path / "prof"), "--device", "cpu"]
    assert torch_main(argv) == 0
    names = {e["name"] for e in _trace_events(tmp_path / "prof")}
    assert "aten::convolution" in names and os.path.isfile(tmp_path / "out" / "segmentation.nii.gz")
