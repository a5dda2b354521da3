"""The port's serving slice end to end against the JAX package's.

One JAX train state (base 4, non-trivial BN statistics) is exported to a
reference-layout .pth with ``export_torch_checkpoint``; the JAX Predictor
and the port's Predictor (pcmseg_tpu_torch/infer/predict.py) both load that
file and segment the same synthetic case directories, whole-volume and
tiled (16³ windows over a 32³ volume), in float32 on the CPU.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.io import read_volume
from pcmseg_tpu.data.nifti import write_nifti
from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
from pcmseg_tpu.infer.predict import load_multimodal_images as jax_load_multimodal_images
from pcmseg_tpu.infer.serve import PredictionServer as JaxPredictionServer
from pcmseg_tpu.infer.sliding_window import _tile_weight as jax_tile_weight
from pcmseg_tpu.infer.sliding_window import _window_starts as jax_window_starts
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train.checkpoints import export_torch_checkpoint
from pcmseg_tpu.train.steps import create_train_state
from pcmseg_tpu_torch.cli.main import main as torch_main
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.infer import sliding_window
from pcmseg_tpu_torch.infer.predict import Predictor, load_multimodal_images
from pcmseg_tpu_torch.infer.serve import PredictionServer
from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth

PROB_ATOL = 2e-4  # the JAX package's own folded-vs-unfolded bound (test_fold_bn.py)
UNDECIDED = 1e-3  # masks may differ only where |p - 0.5| is below this
CASE_SHAPES = {"case_a": (32, 32, 32), "case_b": (20, 36, 24)}
# each package's config is built from these same arguments
CONFIG_ARGS = dict(base_features=4, remat=False, compute_dtype="float32", target_size=(16, 16, 16))


def _configs(**overrides):
    """(the JAX package's config, the port's), from the same arguments."""
    kw = {**CONFIG_ARGS, **overrides}
    return jax_get_config("quick", **kw), get_config("quick", **kw)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _write_case(root, case_id, shape, modalities, rng):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    blob = np.exp(-4 * (z**2 + y**2 + x**2))
    for i, m in enumerate(modalities):
        os.makedirs(os.path.join(root, case_id, m))
        data = 400 * blob * (1 + 0.2 * i) + rng.normal(0, 20, size=shape)
        write_nifti(data.astype(np.int16), os.path.join(root, case_id, m, "image.nii.gz"))


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    jax_config, config = _configs()
    model = JaxUNet3D.from_config(jax_config)
    state = create_train_state(jax_config, jax.random.key(0), model, (1, 16, 16, 16, 5))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (
            rng.uniform(0.5, 1.5, size=a.shape)
            if str(path[-1]) == "['var']"
            else rng.normal(0.0, 0.1, size=a.shape)
        ).astype(np.float32),
        jax.device_get(state.batch_stats),
    )
    state = state.replace(batch_stats=stats)
    pth = str(root / "model.pth")
    export_torch_checkpoint(pth, state, meta={"config": jax_config.to_dict()})

    inbox = str(root / "inbox")
    for case_id, shape in CASE_SHAPES.items():
        _write_case(inbox, case_id, shape, config.modalities, rng)

    # centre the output bias on the median logit so that masks hold both classes
    sd, snap = load_pth(pth)
    probe = Predictor(config, pth, device="cpu")
    image, _ = probe.load_case(os.path.join(inbox, "case_a"))
    p = np.clip(probe.predict_probs(image), 1e-6, 1 - 1e-6)
    sd["outc.bias"] -= float(np.median(np.log(p / (1 - p))))
    save_pth(pth, sd, snap)
    return config, pth, inbox, image


@pytest.fixture(scope="module", params=["whole", "tiled"])
def predictors(request, slice_setup):
    _, pth, inbox, image = slice_setup
    jax_config, config = _configs(**({"window_size": (16, 16, 16)} if request.param == "tiled" else {}))
    return JaxPredictor(jax_config, pth), Predictor(config, pth, device="cpu"), image


def test_probabilities_match_jax(predictors):
    jax_pred, port, image = predictors
    want = jax_pred.predict_probs(image)
    got = port.predict_probs(image)
    assert got.shape == want.shape == image.shape[:3] + (1,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert 0.05 < (want > 0.5).mean() < 0.95  # both classes present


def test_masks_match_jax(predictors):
    jax_pred, port, image = predictors
    want_p = jax_pred.predict_probs(image)[..., 0]
    want = jax_pred.predict_mask(image)
    got = port.predict_mask(image)
    assert got.dtype == np.uint8 and got.shape == image.shape[:3]
    decided = np.abs(want_p - 0.5) >= UNDECIDED
    np.testing.assert_array_equal(got[decided], want[decided])


@pytest.mark.parametrize("size,window,overlap", [(32, 16, 0.5), (40, 16, 0.5), (16, 16, 0.5), (33, 16, 0.25)])
def test_window_starts_match_jax(size, window, overlap):
    stride = max(1, int(round(window * (1 - overlap))))
    assert sliding_window._window_starts(size, window, stride) == jax_window_starts(size, window, stride)


@pytest.mark.parametrize("blend", ["gaussian", "uniform"])
def test_tile_weight_matches_jax(blend):
    np.testing.assert_array_equal(
        sliding_window._tile_weight((16, 12, 20), blend), jax_tile_weight((16, 12, 20), blend)
    )


def test_tile_groups_pad_and_skip():
    calls = []

    def apply_fn(tiles):
        calls.append(tiles.shape[0])
        return torch.ones(*tiles.shape[:4], 1)

    run = sliding_window.make_sliding_window(
        apply_fn, (20, 16, 16), 2, 1, window_size=(16, 16, 16), overlap=0.5, tile_batch=4
    )
    out = run(torch.zeros(20, 16, 16, 2))
    assert calls == [2]  # two tiles along D, one group of two
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6)
    calls.clear()
    run = sliding_window.make_sliding_window(
        apply_fn, (44, 16, 16), 2, 1, window_size=(16, 16, 16), overlap=0.5, tile_batch=2
    )
    assert len(sliding_window.tile_starts((44, 16, 16), (16, 16, 16), 0.5)) == 5
    np.testing.assert_allclose(run(torch.zeros(44, 16, 16, 2)).numpy(), 1.0, rtol=1e-6)
    assert calls == [2, 2, 2]  # the last group is padded, its pad tile skipped


@pytest.mark.parametrize("strategy", ["zero_fill", "duplicate", "skip"])
def test_missing_modality_strategies_match_jax(slice_setup, tmp_path, strategy):
    config, _, inbox, _ = slice_setup
    case = str(tmp_path / "case")
    shutil.copytree(os.path.join(inbox, "case_b"), case)
    shutil.rmtree(os.path.join(case, config.modalities[2]))
    kw = dict(modalities=config.modalities, handle_missing=strategy, normalize="percentile")
    if strategy == "skip":
        with pytest.raises(FileNotFoundError):
            load_multimodal_images(case, **kw)
        return
    got, ref = load_multimodal_images(case, **kw)
    want, _ = jax_load_multimodal_images(case, **kw)
    assert got.dtype == np.float32 and ref.shape == CASE_SHAPES["case_b"]
    np.testing.assert_array_equal(got, want)


def test_server_writes_the_jax_servers_masks(slice_setup, tmp_path):
    _, pth, inbox, _ = slice_setup
    jax_config, config = _configs(window_size=(16, 16, 16))
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert JaxPredictionServer(jax_config, pth, inbox, jax_out, min_age=0.0).run_once()["done"] == 2
    server = PredictionServer(config, pth, inbox, port_out, min_age=0.0, device="cpu")
    assert server.pending_cases() == sorted(CASE_SHAPES)
    assert server.run_once() == {"done": 2, "failed": 0, "skipped": 0, "waiting": 0}
    assert sorted(server.latencies) == sorted(CASE_SHAPES)
    assert server.pending_cases() == []  # outputs mark the cases done
    for case_id, shape in CASE_SHAPES.items():
        got = read_volume(os.path.join(port_out, case_id, "segmentation.nii.gz"))
        want = read_volume(os.path.join(jax_out, case_id, "segmentation.nii.gz"))
        assert got.data.dtype == np.uint8 and got.shape == shape
        assert got.spacing == want.spacing and got.origin == want.origin
        probs, _ = server.predictor.predict_case(os.path.join(inbox, case_id))
        decided = np.abs(probs[..., 0] - 0.5) >= UNDECIDED
        np.testing.assert_array_equal(got.data[decided], want.data[decided])


def test_server_counts_a_bad_case_and_carries_on(slice_setup, tmp_path):
    config, pth, inbox, _ = slice_setup
    root = str(tmp_path / "inbox")
    shutil.copytree(inbox, root)
    with open(os.path.join(root, "case_a", config.modalities[0], "image.nii.gz"), "wb") as f:
        f.write(b"garbage")
    server = PredictionServer(config, pth, root, str(tmp_path / "out"), min_age=0.0, max_attempts=2, device="cpu")
    assert server.run_once() == {"done": 1, "failed": 1, "skipped": 0, "waiting": 0}
    assert server.run_once()["failed"] == 1  # the same case, counted once
    assert server.pending_cases() == []  # quarantined after two attempts
    assert server.stats["skipped"] == 1


def test_cli_predict_and_unported_verbs(slice_setup, tmp_path, capsys):
    _, pth, inbox, _ = slice_setup
    out = str(tmp_path / "out")
    argv = ["predict", "--model_path", pth, "--input_dir", os.path.join(inbox, "case_b"),
            "--output_dir", out, "--base_features", "4", "--device", "cpu"]
    assert torch_main(argv) == 0
    assert read_volume(os.path.join(out, "segmentation.nii.gz")).shape == CASE_SHAPES["case_b"]
    for verb in (["export", "--model_path", pth, "--output", str(tmp_path / "x.pth")],
                 ["validate", "--model_path", pth], ["check"]):
        assert torch_main(verb) != 0
        assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize(
    "overrides,names",
    [
        ({"tta": True}, "tta"),
        ({"spatial_parallel": 2}, "spatial_parallel"),
        ({"device_ingest": True}, "device_ingest"),
        ({"postprocess": "largest_cc"}, "postprocess"),
        ({"min_component_voxels": 10}, "min_component_voxels"),
        ({"n_classes": 3}, "n_classes"),
        ({"profile_dir": "trace"}, "profile_dir"),
    ],
)
def test_unported_options_are_refused(slice_setup, overrides, names):
    config, pth, _, _ = slice_setup
    with pytest.raises(NotImplementedError, match=names):
        Predictor(config.replace(**overrides), pth, explicit=list(overrides), device="cpu")


def test_fold_ensemble_is_refused(slice_setup):
    config, pth, _, _ = slice_setup
    with pytest.raises(NotImplementedError, match="fold-ensemble"):
        Predictor(config, f"{pth},{pth}", device="cpu")


def test_predictor_reads_the_checkpoint_once(slice_setup, monkeypatch):
    config, pth, _, _ = slice_setup
    reads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: reads.append(a[0]) or real_load(*a, **k))
    Predictor(config, pth, device="cpu")
    assert reads == [pth]  # one read serves the config snapshot and the weights


def test_serving_without_a_device_needs_cuda(slice_setup, tmp_path, monkeypatch, capsys):
    """No entry point falls back to the CPU on its own: without a card the
    Predictor, the PredictionServer and the ``predict`` verb raise unless
    asked for the CPU."""
    config, pth, inbox, _ = slice_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor(config, pth)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PredictionServer(config, pth, inbox, str(tmp_path / "out"), min_age=0.0)
    argv = ["predict", "--model_path", pth, "--input_dir", os.path.join(inbox, "case_a"),
            "--output_dir", str(tmp_path / "cli")]
    assert torch_main(argv) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu"]) == 0
