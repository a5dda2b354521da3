"""The port's Trainer on a data 2 × spatial 2 × model 2 mesh, as
``tests/test_trainer_sharded.py:52-66`` trains the JAX package's.

An 8-process gloo cluster whose workers are this file itself (``python
tests/test_torch_tp_trainer.py PID NPROC PORT DATA OUT``, with a timeout)
trains ``Trainer(config.replace(tensor_parallel=2, spatial_parallel=2))``
at 16³ (base 4, float32, batch 4 in 2 microbatches, validation) for 2
epochs streamed, then 1 epoch from the device cache and, resumed from its
checkpoint (the whole state cut to each rank's shards again), the second.
Every rank's histories are bitwise equal; the resumed cached run's
history equals the streamed run's bit for bit; and the streamed run's
equals one process's (no group) within ``tests/test_torch_multihost.py``'s
bounds. The checkpoints hold the whole reference layout: ``best.pth``
loads strictly into the JAX Validator and scores as the port's Validator
scores it, per case within the Dice gate.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 8
TRAINER = dict(batch_size=4, accum_steps=2, num_epochs=2, validation=True, eps=1e-2, base_features=4,
               remat=False, compute_dtype="float32", target_size=(16, 16, 16), early_stopping=False)
MESH = dict(data_parallel=2, spatial_parallel=2, tensor_parallel=2)
DICE_ATOL = 2e-3  # per case, tests/test_torch_validate.py's gate


def _config(data_dir, save_dir, **kw):
    from pcmseg_tpu_torch.core.config import get_config

    return get_config("quick", data_dir=data_dir, save_dir=save_dir, **dict(TRAINER, **kw))


def _worker(pid: int, nproc: int, port: int, data: str, out: str) -> int:
    import torch

    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid, backend="gloo")
    multihost.establish_collectives()
    histories = {}
    trainer = Trainer(_config(data, os.path.join(out, "streamed"), device_data_cache_gb=0.0, **MESH), device="cpu")
    assert trainer.mesh.shape == {"data": 2, "spatial": 2, "model": 2} and trainer._dcache is None
    histories["streamed"] = trainer.train()
    cached = os.path.join(out, "cached")
    first = Trainer(_config(data, cached, num_epochs=1, device_data_cache_gb=1.0, **MESH), device="cpu")
    assert first._dcache is not None
    first.train()
    resumed = Trainer(_config(data, cached, resume=True, device_data_cache_gb=1.0, **MESH), device="cpu")
    assert resumed.start_epoch == 1
    histories["cached_resumed"] = resumed.train()
    torch.save(histories, os.path.join(out, f"histories.{pid}.pt"))
    multihost.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(data root, output root, every rank's histories, one process's
    history and save dir)."""
    import torch

    from pcmseg_tpu.data.synthetic import make_synthetic_dataset
    from pcmseg_tpu_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("tp_trainer")
    data, out = str(root / "data"), str(root / "out")
    make_synthetic_dataset(data, n_cases=6, shape=(12, 12, 12), seed=7)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(NPROC), str(port), data, out],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(NPROC)]
    try:
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:  # one process, while the cluster trains
            one_dir = str(root / "one")
            one = Trainer(_config(data, one_dir, device_data_cache_gb=0.0), device="cpu").train()
        finally:
            torch.set_num_threads(prev)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    ranks = [torch.load(os.path.join(out, f"histories.{pid}.pt"), weights_only=True) for pid in range(NPROC)]
    return data, out, ranks, one, one_dir


def test_tp_trainer_ranks_agree_and_match_one_process(trained):
    _, _, ranks, one, _ = trained
    for r in ranks[1:]:
        assert r == ranks[0]
    got = ranks[0]["streamed"]
    assert ranks[0]["cached_resumed"] == got
    assert len(got["train_loss"]) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=0, err_msg=key)
    for key in ("val_dice", "val_iou"):
        np.testing.assert_allclose(got[key], one[key], rtol=0, atol=5e-4, err_msg=key)


def test_tp_checkpoints_are_whole_and_score_alike(trained, tmp_path):
    """The 2 × 2 × 2 run's ``best.pth`` and ``latest.pt`` hold every leaf in
    its whole reference shape (Adam's moments too), as one process's do;
    the JAX Validator loads the ``.pth`` strictly and scores every case as
    the port's Validator does."""
    import torch

    from pcmseg_tpu.core.config import get_config as jax_get_config
    from pcmseg_tpu.infer.validate import Validator as JaxValidator
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.train.checkpoints import load_pth

    data, out, _, _, one_dir = trained
    pth = os.path.join(out, "streamed", "best.pth")
    got, _ = load_pth(pth)
    want, _ = load_pth(os.path.join(one_dir, "best.pth"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    latest = torch.load(os.path.join(out, "streamed", "latest.pt"), weights_only=True)
    names = [k for k in latest["model"] if not k.rsplit(".", 1)[1].startswith(("running_", "num_batches"))]
    assert len(latest["optimizer"]["state"]) == len(names)
    for i, entry in latest["optimizer"]["state"].items():
        assert entry["exp_avg"].shape == entry["exp_avg_sq"].shape == latest["model"][names[int(i)]].shape
    kw = dict(data_dir=data, cache_dir=str(tmp_path / "cache"), base_features=4, remat=False,
              compute_dtype="float32", target_size=(16, 16, 16), batch_size=4)
    jax_result = JaxValidator(jax_get_config(save_dir=str(tmp_path / "jax"), **kw), pth).validate()
    port_result = Validator(get_config(save_dir=str(tmp_path / "port"), **kw), pth, device="cpu").validate()
    assert port_result["case_count"] == jax_result["case_count"] == 6
    for g, w in zip(port_result["case_results"], jax_result["case_results"]):
        assert g["case_id"] == w["case_id"]
        assert abs(g["dice"] - w["dice"]) <= DICE_ATOL and abs(g["iou"] - w["iou"]) <= DICE_ATOL, (g, w)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
