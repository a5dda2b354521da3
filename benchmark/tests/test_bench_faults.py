"""A run with its timed path broken underneath comes out not correct: the
harness's drivers at base 4 and 32³ on the CPU (the look for a card
skipped), each fault planted in the program, judged by the cell's own
limits. The training cell computes in float32 here, where its sound run
reads far under them (bf16 at base 4 reads above them), and a sound run of
it comes out correct. Training: a step that leaves the state
unchanged; half of the batch left out, the mean taken over the rest.
Serving: a mask altered where it is written; half of the TTA flips left
out, the mean taken over the rest. One card has no exchange between chips
to leave out."""

import pytest
import torch

from benchmark.drivers import serve
from benchmark.lib import harness


def tiny(name, seconds=2.0, **traffic):
    cell = harness.load_cell(name, 2 ** 31 + 17, seconds, False)
    cell.config = dict(cell.config, base_features=4, target_size=[32, 32, 32])
    cell.traffic = dict(cell.traffic, **traffic)
    cell.device = "cpu"
    return cell


def judged(cell):
    out = harness.driver(cell).run(cell)
    return out.failed == 0 and all(c.ok for c in out.checks), {c.name: c.value for c in out.checks}


@pytest.fixture
def train_cell():
    cell = tiny("bn_train_b4", cohort=12)
    cell.config["compute_dtype"] = "float32"
    return cell


def test_train_sound_run_is_correct(train_cell):
    correct, found = judged(train_cell)
    assert correct, found


def test_train_state_left_unchanged(train_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    correct, found = judged(train_cell)
    assert not correct and found["change_gap"] >= 0.99


def test_train_half_the_batch(train_cell, monkeypatch):
    from benchmark.drivers import train
    from pcmseg_tpu_torch.data import device_cache

    port_config, gather = train.port_config, device_cache.gather_rows
    monkeypatch.setattr(train, "port_config", lambda cfg: port_config(cfg).replace(accum_steps=2))
    monkeypatch.setattr(device_cache, "gather_rows",
                        lambda images, labels, idx, *a, **k: gather(images, labels, idx[: len(idx) // 2], *a, **k))
    correct, found = judged(train_cell)
    assert not correct


@pytest.fixture
def serve_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(serve, "CACHE", tmp_path)
    return tiny("bn_serve_ens5_tta_backlog", weight_seed=7, members=2, sample=2)


def test_serve_mask_altered(serve_cell, monkeypatch):
    from pcmseg_tpu_torch.infer.predict import Predictor

    save = Predictor.save_mask

    def altered(self, mask, reference, path):
        mask = mask.copy()
        mask[:4] ^= 1
        return save(self, mask, reference, path)

    monkeypatch.setattr(Predictor, "save_mask", altered)
    correct, found = judged(serve_cell)
    assert not correct and found["mask_gap"] > 0.1


def test_serve_half_the_flips(serve_cell, monkeypatch):
    from pcmseg_tpu_torch.infer import tta

    monkeypatch.setattr(tta, "FLIP_SETS", tta.FLIP_SETS[::2])
    correct, found = judged(serve_cell)
    assert not correct
