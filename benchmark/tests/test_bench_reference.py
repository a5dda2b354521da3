"""The plain reference against the program's plain CPU path at base 4, both
in float32: a cached train step's readings (loss, first gradient and state
change per leaf) for both configurations, and the fold ensemble's 8-flip
probabilities from ``.pth`` members. The train steps run at 32³: at 16³ the
bottleneck's BatchNorm normalizes one voxel and its gradient is round-off."""

import json

import numpy as np
import pytest
import torch

from benchmark.drivers import serve, train
from benchmark.lib import synth
from benchmark.lib.harness import BENCH_DIR, Cell
from benchmark.reference import unet3d as ref

CONFIGS = {n: json.loads((BENCH_DIR / "configs" / f"{n}.json").read_text())
           for n in ("unet3d_b64_bn", "unet3d_b64_gn_k3")}


def tiny(name, **kw):
    return dict(CONFIGS[name], base_features=4, target_size=[32, 32, 32], compute_dtype="float32", **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_the_reference(name):
    cfg = tiny(name)
    cell = Cell("t", cfg, {"driver": "train", "cohort": 12, "first_steps": 3}, 1, 1234, 0.0, False, "cpu")
    program = train.Program(cell)
    found = train.gaps(program.readings,
                       train.reference_readings(cfg, cell.seed, torch.device("cpu"), program.first_batches()))
    # float32 on both sides: only the order of the sums differs
    assert found["loss_gap"] < 1e-5
    assert found["grad_gap"] < 1e-3
    assert found["change_gap"] < 1e-3


def test_state_layout_loads_strictly_into_the_program():
    from pcmseg_tpu_torch.models.unet3d import UNet3D, param_count

    for name, cfg in CONFIGS.items():
        sd = synth.init_state(dict(cfg, base_features=4), 3, "cpu")
        pcfg = train.port_config(dict(cfg, base_features=4))
        model = UNet3D.from_config(pcfg, device="meta")
        model.load_state_dict(sd, strict=True, assign=True)
        assert set(sd) == set(model.state_dict())
        assert param_count(UNet3D.from_config(train.port_config(cfg), device="meta")) == cfg["parameters"]


def test_ensemble_tta_probabilities_match_the_reference(tmp_path):
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor

    cfg = dict(CONFIGS["unet3d_b64_bn"], base_features=4, target_size=[16, 16, 16])
    members = [synth.init_state(cfg, 99 + i, "cpu", trained_stats=True) for i in range(2)]
    paths = []
    for i, sd in enumerate(members):
        paths.append(str(tmp_path / f"m{i}.pth"))
        torch.save({"model_state_dict": sd, "config": {k: cfg[k] for k in serve.SNAPSHOT_KEYS}}, paths[-1])
    predictor = Predictor(get_config("standard", tta=True, compute_dtype="float32"), paths, device="cpu")
    x = torch.rand((1, 16, 16, 16, 5), generator=torch.Generator().manual_seed(5))
    got = predictor.predict_probs_batch(x.numpy())[0, ..., 0]
    want = ref.ensemble_probabilities(members, x.permute(0, 4, 1, 2, 3), tta=True)[0, 0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_percentile_normalize_matches_numpy():
    a = np.random.default_rng(0).integers(0, 3000, (8, 9, 10)).astype(np.int16)
    lo, hi = np.percentile(a, [1, 99])
    np.testing.assert_allclose(ref.percentile_normalize(a), (np.clip(a, lo, hi) - lo) / (hi - lo), atol=1e-7)
    assert not ref.percentile_normalize(np.zeros((4, 4, 4), np.int16)).any()
