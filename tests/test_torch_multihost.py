"""Data-parallel training of pcmseg_tpu_torch across processes on gloo CPU
clusters, mirroring ``tests/test_multihost.py`` at base 4 / 16³ (cases of
12³ resampled): every process a worker started by ``subprocess`` from this
file itself (``python tests/test_torch_multihost.py MODE PID NPROC PORT DATA
CKPT``), trains through the full ``Trainer`` and prints its history.

In every cluster the histories (train and val losses, Dice, IoU) are
bitwise equal across processes: they are global reductions, identical on
every rank. Beyond JAX's test:

  * the 2-process streamed run is held against the same config trained in
    one process, the losses to rtol 1e-5: only the order of fp32 sums
    differs (the global batch's statistics summed per rank, then over the
    ranks), with Adam's eps at 1e-2 so that gradient noise is not turned
    into ±lr steps; Dice and IoU to atol 5e-4, one voxel's flip;
  * the cached and the asynchronous-checkpoint runs of the same config are
    bitwise equal to the streamed one (the same rows reach the same steps);
  * ``torchrun --nproc_per_node 2 -m pcmseg_tpu_torch train`` trains on a
    2-rank mesh, the primary alone logging and writing;
  * the 2-process run uses layout (a) with 2 microbatches (a rank's rows
    interleaved), the 4-process run over 7 cases layout (b) (each rank one
    whole microbatch of 1 sample, its running statistics replayed in
    order), the kill-and-resume cluster layout (a) with 1 row per rank;
  * a 2-fold cross-validation under the process group;
  * a group of one rank, where every collective runs as an identity,
    trains as no group does;
  * a checkpoint write that fails on the primary fails every process at
    the store's barrier, at once.

Every subprocess call has a timeout of its own, so a hang fails its test.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for one cluster; a run takes about 10

# per mode: processes, cases, and the config's differences from BASE. Adam's
# eps is well above the gradients' fp32 rounding noise: at 1e-8 an element
# whose gradient is noise moves by ±lr whichever way the noise falls, and the
# one-process comparison would measure that (1.2e-5 relative at epoch 1)
BASE = dict(batch_size=4, accum_steps=2, num_epochs=2, validation=True, eps=1e-2)
MODES = {
    "sync": dict(nproc=2, n_cases=6),
    "cache": dict(nproc=2, n_cases=6, device_data_cache_gb=1.0),
    "async": dict(nproc=2, n_cases=6, async_checkpoint=True),
    # about 8 of the 12 cases fit 2 cards: 8 resident (4 on each), 4 streamed
    "pcache": dict(nproc=2, n_cases=12, device_data_cache_gb=8.5 * 16**3 * 11 / 2 / 1e9),
    # 7 cases over 4 processes, batch 4 as 4 microbatches of 1: layout (b)
    "uneven": dict(nproc=4, n_cases=7, accum_steps=4, validation=False),
    "cv": dict(nproc=2, n_cases=6, cross_validation=True, num_epochs=1),
    # a group of one rank: every collective runs, as identities
    "one": dict(nproc=1, n_cases=6, device_data_cache_gb=1.0, async_checkpoint=True),
    "ref": dict(nproc=4, n_cases=6, accum_steps=1, num_epochs=3, validation=False),
    "crash": dict(nproc=4, n_cases=6, accum_steps=1, num_epochs=3, validation=False),
    "resume": dict(nproc=4, n_cases=6, accum_steps=1, num_epochs=3, validation=False, resume=True),
    # the primary's checkpoint write fails, written now or by the writer thread
    "failwrite": dict(nproc=2, n_cases=6, num_epochs=1, validation=False),
    "failwrite_async": dict(nproc=2, n_cases=6, num_epochs=1, validation=False, async_checkpoint=True),
}


def _config(mode, data_dir, save_dir):
    from pcmseg_tpu_torch.core.config import get_config

    kw = dict(BASE, **{k: v for k, v in MODES[mode].items() if k not in ("nproc", "n_cases", "cross_validation")})
    kw.setdefault("device_data_cache_gb", 0.0)
    return get_config(
        "quick", data_dir=data_dir, save_dir=save_dir, base_features=4, remat=False,
        compute_dtype="float32", target_size=(16, 16, 16), early_stopping=False, n_splits=2, **kw,
    )


def _worker(mode, pid, nproc, port, data_dir, save_dir) -> int:
    """One process of a cluster: train, print the history as JSON."""
    import torch

    torch.set_num_threads(1)
    from pcmseg_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    assert multihost.process_count() == nproc and multihost.is_primary() == (pid == 0)
    multihost.establish_collectives()
    config = _config(mode, data_dir, save_dir)
    if MODES[mode].get("cross_validation"):
        from pcmseg_tpu_torch.train.cv import CrossValidationTrainer

        cv = CrossValidationTrainer(config, device="cpu")
        cv.train()
        histories = [json.load(open(os.path.join(save_dir, f"fold_{k}_history.json"))) for k in range(2)]
        print("MULTIHOST_OK " + json.dumps({"pid": pid, "history": histories}), flush=True)
        return 0
    from pcmseg_tpu_torch.train.trainer import Trainer

    if mode == "sync":
        # a mesh that does not span the processes raises; a spatial and a
        # tensor-parallel mesh over the processes build (tests/test_torch_sp_parity.py
        # and tests/test_torch_tp_trainer.py train them)
        for bad, error in ((dict(data_parallel=1), ValueError), (dict(tensor_parallel=nproc + 1), ValueError)):
            try:
                Trainer(config.replace(**bad), device="cpu")
            except error as e:
                assert "processes" in str(e) or "devices" in str(e), e
            else:
                raise AssertionError(f"{bad} built a trainer over {nproc} processes")
        spatial = Trainer(config.replace(spatial_parallel=nproc), device="cpu")
        assert spatial.mesh.shape == {"data": 1, "spatial": nproc, "model": 1}
        tensor = Trainer(config.replace(tensor_parallel=nproc), device="cpu")
        assert tensor.mesh.shape == {"data": 1, "spatial": 1, "model": nproc}
        assert tensor.state.model.inc.conv[0].weight.shape[0] * nproc == 4  # this rank's shard of base 4
    trainer = Trainer(config, device="cpu")
    assert trainer.mesh.shape == {"data": nproc, "spatial": 1, "model": 1}
    if mode == "cache":  # each process decoded and holds its block of the 6 cases only
        assert trainer._dcache["rows"] == range(3 * pid, 3 * pid + 3)
        assert trainer._dcache["images"].shape[0] == 3
    if mode in ("cache", "pcache", "one"):
        assert trainer._dcache is not None and trainer._dcache["rows"] is not None
        assert trainer._dcache_partial == (mode == "pcache")
    if mode == "pcache":
        assert trainer._dcache["images"].shape[0] == 4 and trainer._stream_train_loader is not None
    if mode == "crash":
        # process 1 dies right after the first step of epoch 1: epoch 0's
        # checkpoint exists, and the others are left in a collective
        step, calls = trainer._train_step, [0]
        per_epoch = len(trainer.train_loader)

        def wrapped(state, batch):
            out = step(state, batch)
            calls[0] += 1
            if pid == 1 and calls[0] == per_epoch + 1:
                print(f"CRASHING pid={pid}", flush=True)
                os._exit(1)
            return out

        trainer._train_step = wrapped
    if mode.startswith("failwrite"):
        import pcmseg_tpu_torch.train.trainer as trainer_module

        def full_disk(*args, **kwargs):
            raise OSError(28, "No space left on device")

        if pid == 0:
            trainer_module.write_train_checkpoint = full_disk
        try:
            trainer.train()
        except Exception as e:
            print(f"WRITE_FAILED {type(e).__name__}: {e}", flush=True)
            multihost.shutdown()
            return 0
        raise AssertionError("train() returned although the primary's checkpoint write failed")
    history = trainer.train()
    print("MULTIHOST_OK " + json.dumps({"pid": pid, "history": history}), flush=True)
    multihost.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(mode, data_dir, save_dir):
    nproc, port = MODES[mode]["nproc"], _free_port()
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(pid), str(nproc), str(port), data_dir, save_dir],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(nproc)
    ]


def _reap(procs, timeout=TIMEOUT):
    """Each process's output; kills them all if one outlives ``timeout``."""
    deadline, outs = time.time() + timeout, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _histories(outs, procs):
    """Every process's history, each process having exited 0."""
    found = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        found.append(json.loads(re.search(r"MULTIHOST_OK (.*)", out).group(1)))
    assert [f["pid"] for f in found] == list(range(len(procs)))
    return [f["history"] for f in found]


def _data(tmp_path_factory, n_cases):
    from pcmseg_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp(f"cases{n_cases}"))
    make_synthetic_dataset(root, n_cases=n_cases, shape=(12, 12, 12), seed=7)
    return root


def _run(mode, data_dir, save_dir):
    procs = _spawn(mode, data_dir, save_dir)
    histories = _histories(_reap(procs), procs)
    # global reductions: bitwise equal on every process
    assert all(h == histories[0] for h in histories), histories
    return histories[0]


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    return _data(tmp_path_factory, 6)


@pytest.fixture(scope="module")
def streamed(six, tmp_path_factory):
    save = str(tmp_path_factory.mktemp("sync"))
    return _run("sync", six, save), save


def test_two_process_streamed_cluster_matches_one_process(streamed, six, tmp_path):
    import torch

    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    history, save = streamed
    assert len(history["train_loss"]) == 2 and len(history["val_loss"]) == 2
    assert np.isfinite(sum(history["train_loss"] + history["val_loss"]))
    # the primary wrote the checkpoints; every process read the same epochs
    for name in ("latest", "best"):
        assert os.path.isfile(train_checkpoint_path(save, name))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = Trainer(_config("sync", six, str(tmp_path / "one")), device="cpu").train()
    finally:
        torch.set_num_threads(prev)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(history[key], one[key], rtol=1e-5, atol=0, err_msg=key)
    # thresholded voxels: a logit within rounding of the threshold flips one
    # voxel, which moves Dice by about 1/(Σp + Σt) (6.2e-5 measured)
    for key in ("val_dice", "val_iou"):
        np.testing.assert_allclose(history[key], one[key], rtol=0, atol=5e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["cache", "async"])
def test_two_process_cluster_equals_streamed(mode, streamed, six, tmp_path):
    """The cached cluster (each process decoding and holding half the cases,
    rows exchanged each step) and the asynchronous-checkpoint cluster train
    bitwise like the streamed one."""
    import torch

    history = _run(mode, six, str(tmp_path / mode))
    assert history == streamed[0]
    if mode == "async":
        meta = torch.load(os.path.join(tmp_path, mode, "latest.pt"), weights_only=True)["meta"]
        assert meta["epoch"] == 1 and os.path.isfile(os.path.join(tmp_path, mode, "best.pth"))


def test_two_process_cluster_partial_device_cache(tmp_path_factory):
    history = _run("pcache", _data(tmp_path_factory, 12), str(tmp_path_factory.mktemp("pcache")))
    assert len(history["train_loss"]) == 2 and np.isfinite(sum(history["train_loss"] + history["val_loss"]))


def test_four_process_cluster_uneven_shards_layout_b(tmp_path_factory):
    """7 cases over 4 processes: the padded tail batch gives the processes
    2, 1, 0 and 0 real samples, each its own whole microbatch."""
    history = _run("uneven", _data(tmp_path_factory, 7), str(tmp_path_factory.mktemp("uneven")))
    assert len(history["train_loss"]) == 2 and np.isfinite(history["train_loss"]).all()


def test_one_rank_group_runs_every_collective_and_matches_no_group(six, tmp_path):
    """A process group of one rank (the chip check's one-rank NCCL run, on
    gloo here): the cache sharded over one rank, rows exchanged, BatchNorm
    and the loss summed through all-reduces, the gradients all-reduced,
    barriers from the writer thread; the same training as without a group
    to rtol 1e-5 (BatchNorm's mean as a sum over the count)."""
    import torch

    from pcmseg_tpu_torch.train.trainer import Trainer

    history = _run("one", six, str(tmp_path / "one"))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        alone = Trainer(_config("one", six, str(tmp_path / "alone")), device="cpu").train()
    finally:
        torch.set_num_threads(prev)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(history[key], alone[key], rtol=1e-5, atol=0, err_msg=key)
    for key in ("val_dice", "val_iou"):
        np.testing.assert_allclose(history[key], alone[key], rtol=0, atol=5e-4, err_msg=key)


def test_cross_validation_under_a_process_group(six, tmp_path):
    histories = _run("cv", six, str(tmp_path / "cv"))
    results = json.load(open(tmp_path / "cv" / "cv_results.json"))
    assert results["summary"]["total_folds"] == 2 and len(histories) == 2
    assert all(len(h["train_loss"]) == 1 for h in histories)


def test_cli_trains_data_parallel_under_torchrun(six, tmp_path):
    """``torchrun --nproc_per_node 2 -m pcmseg_tpu_torch train --device cpu``
    joins the process group from torchrun's environment and trains on a
    2-rank mesh; the primary alone logs the epochs and writes checkpoints."""
    import torch

    save = str(tmp_path / "cli")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "pcmseg_tpu_torch", "train", "--device", "cpu", "--preset", "quick", "--data_dir", six,
           "--save_dir", save, "--base_features", "4", "--target_size", "16", "16", "16",
           "--batch_size", "4", "--epochs", "2", "--device_cache_gb", "0", "--remat", "0"]
    proc = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert out.count("mesh {'data': 2, 'spatial': 1, 'model': 1}") == 1  # the primary's log only
    meta = torch.load(os.path.join(save, "latest.pt"), weights_only=True)["meta"]
    assert meta["epoch"] == 1 and np.isfinite(meta["history"]["train_loss"]).all()


def test_cluster_kill_one_process_then_resume(six, tmp_path):
    """Process 1 hard-dies after the first step of epoch 1; epoch 0's
    ``latest`` survives, and the whole cluster restarted with resume=True
    reproduces the uninterrupted run's losses bitwise."""
    import torch

    ref = _run("ref", six, str(tmp_path / "ref"))
    assert len(ref["train_loss"]) == 3
    ckpt = str(tmp_path / "crash")
    procs = _spawn("crash", six, ckpt)
    try:
        procs[1].wait(timeout=TIMEOUT)
        time.sleep(2.0)  # the others fail in their collective, or are stopped now
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
    outs = _reap(procs, timeout=60)
    assert procs[1].returncode == 1 and "CRASHING pid=1" in outs[1], outs[1][-3000:]
    meta = torch.load(os.path.join(ckpt, "latest.pt"), weights_only=True)["meta"]
    assert meta["epoch"] == 0
    resumed = _run("resume", six, ckpt)
    assert resumed == ref


@pytest.mark.parametrize("mode", ["failwrite", "failwrite_async"])
def test_failed_primary_write_fails_every_process_at_once(mode, six, tmp_path):
    """The primary's checkpoint write raises: it still arrives at the
    store's barrier with the error, so the other process raises it at once
    instead of waiting out the barrier's 10-minute timeout."""
    procs = _spawn(mode, six, str(tmp_path / mode))
    outs = _reap(procs, timeout=120)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert "WRITE_FAILED OSError: [Errno 28] No space left on device" in outs[0], outs[0][-3000:]
    assert re.search(r"WRITE_FAILED RuntimeError: barrier .*process 0: checkpoint write failed: OSError: "
                     r"\[Errno 28\] No space left on device", outs[1]), outs[1][-3000:]


if __name__ == "__main__":
    mode, pid, nproc, port, data_dir, save_dir = sys.argv[1:7]
    sys.exit(_worker(mode, int(pid), int(nproc), int(port), data_dir, save_dir))
