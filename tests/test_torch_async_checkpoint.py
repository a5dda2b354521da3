"""Asynchronous checkpoints of the port's trainer (``async_checkpoint``:
train/checkpoints.py ``AsyncCheckpointWriter``, train/trainer.py) on the CPU,
after tests/test_checkpoints.py:251-289 and the async half of :340-380:
async files load bitwise equal to synchronous ones, a resume from an async
``latest`` equals the uninterrupted run, collapse and backpressure in order
with a writer slowed on purpose, a snapshot that the next step cannot
change, a writer failure raised at the next epoch boundary, and ``close()``
on an exception inside an epoch."""

import os
import threading
import time

import pytest
import torch

from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.train import trainer as trainer_module
from pcmseg_tpu_torch.train.checkpoints import AsyncCheckpointWriter, train_checkpoint_path
from pcmseg_tpu_torch.train.steps import TrainState
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
    make_synthetic_dataset(root, n_cases=4, shape=(20, 20, 20), seed=5)
    return root


def _config(tree, save_dir, **kw):
    base = dict(
        data_dir=tree, save_dir=str(save_dir), base_features=4, compute_dtype="float32", remat=False,
        target_size=(16, 16, 16), batch_size=2, num_epochs=3, validation=False, early_stopping=False,
        save_frequency=2, keep_checkpoints=2, device_data_cache_gb=0.0, seed=3, learning_rate=1e-3,
    )
    base.update(kw)
    return get_config(**base)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal_trees(a, b, where=""):
    """Every tensor bitwise equal, every other leaf equal."""
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _without_run_keys(payload):
    """A loaded checkpoint with the two keys its config snapshot may differ in
    between the runs compared (``save_dir``, ``async_checkpoint``) taken out."""
    config = payload["meta"]["config"] if "meta" in payload else payload["config"]
    for key in ("save_dir", "async_checkpoint"):
        config.pop(key)
    return payload


def _params(trainer):
    return [p.detach().clone() for p in trainer.state.model.state_dict().values()]


def test_async_files_equal_sync(tree, tmp_path):
    """The same 3 epochs synchronous and asynchronous: equal histories and
    parameters, and latest, best (a copy of latest), epoch_2 and best.pth
    load to bitwise-equal tensors and equal meta."""
    runs = {}
    for name, async_ckpt in (("sync", False), ("async", True)):
        trainer = Trainer(_config(tree, tmp_path / name, async_checkpoint=async_ckpt), device="cpu")
        runs[name] = (trainer.train(), _params(trainer))
        if async_ckpt:
            assert trainer.writer.in_flight() == 0 and trainer.writer._pool is None  # drained and closed
            assert trainer.writer.stats["submitted"] == 3
    assert runs["sync"][0] == runs["async"][0]
    for a, b in zip(runs["sync"][1], runs["async"][1]):
        assert torch.equal(a, b)
    for name in ("latest", "best", "epoch_2"):
        sync, asyn = (_without_run_keys(_load(train_checkpoint_path(str(tmp_path / d), name)))
                      for d in ("sync", "async"))
        _assert_equal_trees(sync, asyn, name)
    sync, asyn = (_without_run_keys(_load(str(tmp_path / d / "best.pth"))) for d in ("sync", "async"))
    _assert_equal_trees(sync, asyn, "best.pth")
    latest = _load(train_checkpoint_path(str(tmp_path / "async"), "latest"))
    assert latest["meta"]["epoch"] == 2 and latest["step"] == 6
    assert sorted(f for f in os.listdir(tmp_path / "async") if f.startswith("epoch_")) == ["epoch_2.pt"]


def test_async_resume_equals_uninterrupted(tree, tmp_path):
    """Killed after epoch 2 and resumed from the async ``latest``: bitwise
    equal to the uninterrupted asynchronous run."""
    full = Trainer(_config(tree, tmp_path / "full", async_checkpoint=True), device="cpu")
    history = full.train()
    killed = _config(tree, tmp_path / "killed", async_checkpoint=True, num_epochs=2)
    Trainer(killed, device="cpu").train()
    resumed = Trainer(killed.replace(num_epochs=3, resume=True), device="cpu")
    assert resumed.start_epoch == 2
    assert resumed.train() == history
    for a, b in zip(_params(full), _params(resumed)):
        assert torch.equal(a, b)


def _state():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    return TrainState(model=model, optimizer=opt, ema=None, step=1)


class _SlowWrites:
    """Writes that record their name and block until ``gate`` opens."""

    def __init__(self):
        self.gate = threading.Event()
        self.started = threading.Event()
        self.order = []

    def __call__(self, name):
        def write(payload):
            self.started.set()
            assert self.gate.wait(10), "gate never opened"
            self.order.append(name)
        return write


def _open_later(gate, seconds):
    timer = threading.Timer(seconds, gate.set)
    timer.start()
    return timer


def test_collapse_and_backpressure_order():
    """With the first write held: a queued 'latest' is collapsed onto the
    next 'latest'; a 'best' then waits (backpressure: two snapshots in
    flight) until the held write ends; 'latest' never cancels a queued
    'best', and 'periodic' never collapses."""
    state, writes = _state(), _SlowWrites()
    writer = AsyncCheckpointWriter("cpu")
    writer.submit("latest", state, writes("A"))
    assert writes.started.wait(10)
    writer.submit("latest", state, writes("B"))  # queued
    writer.submit("latest", state, writes("C"))  # B collapses onto C
    assert writer.stats["collapsed"] == 1
    timer = _open_later(writes.gate, 0.3)
    t0 = time.perf_counter()
    writer.submit("best", state, writes("D"))  # A and C in flight: waits for A
    assert time.perf_counter() - t0 >= 0.25 and writer.stats["blocked_s"] >= 0.25
    writer.drain(wait=True)
    timer.join(10)
    assert writes.order == ["A", "C", "D"]

    writes = _SlowWrites()
    writer = AsyncCheckpointWriter("cpu", max_outstanding=5)
    writer.submit("latest", state, writes("A"))
    assert writes.started.wait(10)
    for kind, name in (("best", "B"), ("latest", "C"), ("periodic", "P1"), ("periodic", "P2")):
        writer.submit(kind, state, writes(name))
    writes.gate.set()
    writer.close()
    assert writes.order == ["A", "B", "C", "P1", "P2"] and writer.stats["collapsed"] == 0
    assert writer.snapshots.pinned_bytes == 0 and writer._pool is None


def test_snapshot_is_isolated_and_reused():
    """The written payload is the state at submit time, whatever the next
    step does to the live tensors; two buffer sets serve every epoch."""
    state, writes = _state(), _SlowWrites()
    writer = AsyncCheckpointWriter("cpu")
    seen = []

    def record(payload):
        writes("x")(payload)
        seen.append({k: v.clone() for k, v in payload["model"].items()})

    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    writer.submit("latest", state, record)
    buffers = {id(b) for b in writer._tasks[0][2].buffers}
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)  # the next epoch
    writes.gate.set()
    writer.drain(wait=True)
    _assert_equal_trees(seen[0], want)
    for _ in range(4):
        writer.submit("periodic", state, lambda payload: None)
    writer.drain(wait=True)
    assert writer.snapshots._n_sets <= 2
    assert any({id(b) for b in bufs} == buffers for _, bufs in writer.snapshots._free)
    writer.close()


def _wait_for_writes(trainer):
    """``train_epoch`` that first lets every queued write finish, so a
    failure is ready when the next epoch boundary looks for it."""
    real = trainer.train_epoch

    def epoch():
        deadline = time.time() + 30
        while trainer.writer.in_flight() and time.time() < deadline:
            time.sleep(0.01)
        return real()

    return epoch


def test_writer_failure_surfaces_at_next_epoch_boundary(tree, tmp_path, monkeypatch):
    calls = []
    real = trainer_module.write_train_checkpoint

    def failing(directory, name, payload, meta=None):
        calls.append(meta["epoch"])
        if meta["epoch"] == 0:
            raise OSError("disk full")
        return real(directory, name, payload, meta)

    monkeypatch.setattr(trainer_module, "write_train_checkpoint", failing)
    trainer = Trainer(_config(tree, tmp_path, async_checkpoint=True), device="cpu")
    trainer.train_epoch = _wait_for_writes(trainer)
    with pytest.raises(OSError, match="disk full"):
        trainer.train()
    # epoch 1 trained; its boundary raised before epoch 1 was saved
    assert len(trainer.history["train_loss"]) == 2 and calls == [0]
    assert trainer.writer._pool is None  # released by close()


def test_close_runs_on_an_exception_inside_the_epoch(tree, tmp_path):
    """An epoch that raises: ``train()`` re-raises it after ``close()``
    completed the queued write of the epoch before and released the thread."""
    trainer = Trainer(_config(tree, tmp_path, async_checkpoint=True, profile_dir=str(tmp_path / "prof")),
                      device="cpu")
    real = trainer.train_epoch
    epochs = []

    def epoch():
        epochs.append(len(epochs))
        if len(epochs) == 2:
            raise FloatingPointError("non-finite training loss")
        return real()

    trainer.train_epoch = epoch
    with pytest.raises(FloatingPointError):
        trainer.train()
    assert trainer.writer._pool is None and trainer.writer.in_flight() == 0
    assert _load(train_checkpoint_path(str(tmp_path), "latest"))["meta"]["epoch"] == 0
    assert trainer.tracer._prof is None
