"""The port's own copy of the host layer (pcmseg_tpu_torch/core/config.py,
cli/parser.py, data/{volume,nifti,mha,io,resample,native,augment}.py,
utils/logging.py) against the JAX package's originals on the same inputs:
the copies must behave identically, faults included."""

import os

import numpy as np
import pytest

from pcmseg_tpu.cli.main import _config_from_args as jax_config_from_args
from pcmseg_tpu.cli.main import build_parser as jax_build_parser
from pcmseg_tpu.core import config as jax_config
from pcmseg_tpu.data import augment as jax_augment
from pcmseg_tpu.data import io as jax_io
from pcmseg_tpu.data import native as jax_native
from pcmseg_tpu.data import resample as jax_resample
from pcmseg_tpu.data.volume import Volume as JaxVolume
from pcmseg_tpu.utils.logging import StepTimer as JaxStepTimer
from pcmseg_tpu_torch.cli.parser import _config_from_args, build_parser
from pcmseg_tpu_torch.core import config
from pcmseg_tpu_torch.data import augment, io, native, resample
from pcmseg_tpu_torch.data.volume import Volume
from pcmseg_tpu_torch.utils.logging import StepTimer


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_config_of_every_preset_matches(preset):
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    assert config.DEFAULT_MODALITIES == jax_config.DEFAULT_MODALITIES
    got = config.get_config(preset, base_features=8, target_size=(32, 32, 32))
    want = jax_config.get_config(preset, base_features=8, target_size=(32, 32, 32))
    assert got.to_dict() == want.to_dict()
    assert config.Config.from_json(want.to_json()).to_dict() == want.to_dict()


ARGV = [
    ["train", "--data_dir", "d", "--epochs", "3", "--batch_size", "2", "--remat", "1", "--preset", "quick"],
    ["train", "--loss", "bce_dice", "--scheduler", "poly", "--train_crop", "32", "32", "32",
     "--oversample_fg", "0.33", "--ema_decay", "0.99", "--no_validation", "--resume"],
    ["predict", "--model_path", "m.pth", "--input_dir", "c", "--threshold", "0.4",
     "--sliding_window", "--window_size", "64", "64", "64", "--window_overlap", "0.25"],
    ["serve", "--model_path", "m.pth", "--input_root", "in", "--once", "--tta", "--no_ema",
     "--normalize", "zscore", "--target_size", "96", "96", "64", "--base_features", "16"],
    ["predict", "--model_path", "m.pth", "--input_dir", "c", "--postprocess", "largest_cc",
     "--min_component_voxels", "10", "--coregister", "--missing_strategy", "duplicate"],
]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: a[0] + "-" + a[1][2:])
@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_config_from_args_matches(argv, device):
    """The port's parser adds ``--device`` to train/predict/serve and reads
    nothing else differently; the JAX parser gets the same line without it."""
    ours = build_parser().parse_args(argv + (["--device", device] if device else []))
    theirs = jax_build_parser().parse_args(argv)
    assert ours.device == (device or "cuda")
    preset = getattr(theirs, "preset", "standard")
    got, got_explicit = _config_from_args(ours, preset=preset, with_explicit=True)
    want, want_explicit = jax_config_from_args(theirs, preset=preset, with_explicit=True)
    assert got.to_dict() == want.to_dict()
    assert got_explicit == want_explicit


def _volume(cls, rng, dtype):
    data = (rng.normal(0, 300, size=(7, 9, 11))).astype(dtype)
    direction = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return cls(data, spacing=(0.5, 0.75, 3.0), origin=(-10.0, 4.5, 2.25), direction=direction)


@pytest.mark.parametrize("name", ["v.nii", "v.nii.gz", "v.mha"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
def test_volume_round_trips_match(tmp_path, name, dtype):
    ours, theirs = str(tmp_path / "ours" / name), str(tmp_path / "theirs" / name)
    os.makedirs(os.path.dirname(ours))
    os.makedirs(os.path.dirname(theirs))
    io.write_volume(_volume(Volume, np.random.default_rng(0), dtype), ours)
    jax_io.write_volume(_volume(JaxVolume, np.random.default_rng(0), dtype), theirs)
    if not name.endswith(".gz"):  # gzip stamps the time into its header
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    got, want = io.read_volume(theirs), jax_io.read_volume(ours)
    assert got.data.dtype == want.data.dtype == dtype
    np.testing.assert_array_equal(got.data, want.data)
    assert got.spacing == want.spacing and got.origin == want.origin
    np.testing.assert_array_equal(got.direction, want.direction)
    np.testing.assert_array_equal(got.affine, want.affine)
    got_h, want_h = io.read_header(ours), jax_io.read_header(theirs)
    if isinstance(want_h, dict):  # MetaImage: the parsed header fields
        assert got_h == want_h
    else:
        assert got_h.shape_xyz == want_h.shape_xyz
        np.testing.assert_array_equal(got_h.affine, want_h.affine)
    assert io.strip_ext(name) == jax_io.strip_ext(name)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("target", [(12, 9, 5), (7, 9, 11), (16, 16, 16)])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_resample_array_matches(mode, target, dtype):
    data = np.random.default_rng(1).normal(0, 100, size=(7, 9, 11)).astype(dtype)
    got = resample.resample_array(data, target, mode)
    want = jax_resample.resample_array(data, target, mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["percentile", "minmax", "zscore", "none"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_normalize_intensity_matches(mode, dtype):
    data = np.random.default_rng(2).normal(200, 80, size=(9, 10, 11)).astype(dtype)
    got = resample.normalize_intensity(data, mode)
    want = jax_resample.normalize_intensity(data, mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_native_library_is_the_ports_own_build():
    """The port builds the same C++ sources into its own build directory,
    and its fused normalize writes what the JAX package's writes."""
    assert native._lib_path() != jax_native._lib_path()
    assert "pcmseg_tpu_torch" in native._lib_path()
    data = np.random.default_rng(3).normal(0, 50, size=(6, 7, 8)).astype(np.int16)
    got, want = np.zeros(2 * data.size, np.float32), np.zeros(2 * data.size, np.float32)
    ok = native.native_normalize_into(data, 1.0, 99.0, got, offset=1, stride=2)
    assert ok == jax_native.native_normalize_into(data, 1.0, 99.0, want, offset=1, stride=2)
    np.testing.assert_array_equal(got, want)


AUGMENTERS = {
    "default": dict(),
    "spatial": dict(scale=0.15, rotate_deg=20.0),
    "intensity": dict(gamma=0.3, noise=0.1, blur_prob=1.0),
    "crop_fg": dict(crop=(8, 8, 8), oversample_fg=1.0),
    "crop_window": dict(crop=(8, 10, 6), oversample_fg=0.5, oversample_mode="window"),
}


@pytest.mark.parametrize("kind", sorted(AUGMENTERS))
def test_augmenter_matches(kind):
    rng = np.random.default_rng(4)
    label = np.zeros((12, 14, 10, 1), np.uint8)
    label[4:8, 5:9, 3:6] = 1
    sample = {"image": rng.normal(size=(12, 14, 10, 5)).astype(np.float32), "label": label, "case_id": "c0"}
    ours = augment.Augmenter(seed=7, **AUGMENTERS[kind])
    theirs = jax_augment.Augmenter(seed=7, **AUGMENTERS[kind])
    for epoch, index in ((0, 0), (0, 3), (2, 1)):
        # each gets its own copy: the blur branch may write into a float32 input
        got = ours({k: np.copy(v) if k != "case_id" else v for k, v in sample.items()}, epoch, index)
        want = theirs({k: np.copy(v) if k != "case_id" else v for k, v in sample.items()}, epoch, index)
        for k in ("image", "label"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kind} {k}")


def test_step_timer_matches():
    ours, theirs = StepTimer(warmup_steps=1), JaxStepTimer(warmup_steps=1)
    for items in (4, 4, 2):
        for t in (ours, theirs):
            t.start()
            t.stop(items)
    assert (ours._steps, ours._items) == (theirs._steps, theirs._items) == (3, 6)
    assert ours.items_per_sec > 0 and theirs.items_per_sec > 0
