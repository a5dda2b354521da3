"""Device-side serving ingest of the port (``device_ingest``:
pcmseg_tpu_torch/infer/predict.py ``load_multimodal_raw``,
``Predictor._device_ingest_stack``, infer/serve.py) on the CPU, after
tests/test_device_ingest.py: the raw loader (missing modalities, ``skip``);
the stack for percentile, minmax and zscore within 1e-5 of JAX's
``_device_ingest_stack`` (fp32 wire) and within 2e-3 of the port's host path;
probabilities end to end; ``duplicate``; the raw dtypes converted on the
host; a volume just above 2**24 voxels against ``np.percentile``; the server."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.infer.predict import Predictor as JaxPredictor
from pcmseg_tpu.infer.predict import load_multimodal_raw as jax_load_multimodal_raw
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train.checkpoints import export_torch_checkpoint
from pcmseg_tpu.train.steps import create_train_state
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data.io import read_volume
from pcmseg_tpu_torch.data.resample import normalize_intensity
from pcmseg_tpu_torch.infer.predict import (
    Predictor,
    load_multimodal_images,
    load_multimodal_raw,
    normalize_on_device,
    percentiles,
)
from pcmseg_tpu_torch.infer.serve import PredictionServer

JAX_ATOL = 1e-5  # the same fp32 arithmetic, reductions in another order
HOST_ATOL = 2e-3  # the host path's own percentiles and scaling (tests/test_device_ingest.py)
PROB_ATOL = 2e-4  # the serving parity bound (tests/test_torch_serving.py)
CONFIG_ARGS = dict(base_features=4, target_size=(16, 16, 16), compute_dtype="float32", remat=False)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A predict-style case dir (one subdir per modality, int16 data, the
    last modality missing) and one JAX train state exported to a .pth."""
    tmp = tmp_path_factory.mktemp("ingest")
    root = str(tmp / "tree")
    make_synthetic_dataset(root, n_cases=1, shape=(20, 20, 20), seed=3)
    config = get_config("quick")
    case = str(tmp / "case000")
    for m in config.modalities[:-1]:
        os.makedirs(os.path.join(case, m))
        shutil.copy(os.path.join(root, "BPH-PCA", "BPH", m, "case000.nii.gz"), os.path.join(case, m, "image.nii.gz"))
    jax_config = jax_get_config("quick", **CONFIG_ARGS)
    model = JaxUNet3D.from_config(jax_config)
    state = create_train_state(jax_config, jax.random.key(0), model, (1, 16, 16, 16, 5))
    pth = str(tmp / "model.pth")
    export_torch_checkpoint(pth, state, meta={"config": jax_config.to_dict()})
    return case, pth


def _predictors(pth, device_ingest, **over):
    """(the JAX package's Predictor, the port's) on the same .pth and config."""
    kw = {**CONFIG_ARGS, "device_ingest": device_ingest, **over}
    return (JaxPredictor(jax_get_config("quick", **kw), pth, explicit=list(over)),
            Predictor(get_config("quick", **kw), pth, explicit=list(over), device="cpu"))


def _zscore64(a):
    x = np.asarray(a, np.float64)
    return (x - x.mean()) / x.std()


class TestRawLoader:
    def test_channels_and_reference(self, setup):
        case, _ = setup
        modalities = get_config("quick").modalities
        channels, ref = load_multimodal_raw(case, modalities=modalities)
        want, want_ref = jax_load_multimodal_raw(case, modalities=modalities)
        assert len(channels) == 5 and channels[-1] is None and want[-1] is None
        for c, w in zip(channels[:-1], want[:-1]):
            assert c.shape == ref.shape == want_ref.shape and c.dtype == w.dtype
            np.testing.assert_array_equal(c, w)

    def test_skip_strategy_raises(self, setup):
        with pytest.raises(FileNotFoundError):
            load_multimodal_raw(setup[0], modalities=get_config("quick").modalities, handle_missing="skip")

    def test_duplicate_fills_from_the_reference(self, setup):
        channels, _ = load_multimodal_raw(setup[0], modalities=get_config("quick").modalities,
                                          handle_missing="duplicate")
        np.testing.assert_array_equal(channels[-1], channels[0])


class TestDeviceIngestParity:
    @pytest.mark.parametrize("normalize", ["percentile", "minmax", "zscore"])
    def test_stack_matches_jax_and_host(self, setup, normalize):
        case, pth = setup
        jax_p, port = _predictors(pth, True, normalize=normalize)
        channels, _ = load_multimodal_raw(case, modalities=port.config.modalities)
        got = port._device_ingest_stack(channels)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
        got = got.numpy()
        want = np.asarray(jax_p._device_ingest_stack(channels), np.float32)
        if normalize == "zscore":
            # XLA:CPU sums JAX's fp32 mean in one chain (3.5e-4 off on this
            # case): both are held against the float64 z-score instead, the
            # port within JAX_ATOL of it and no further from it than JAX
            exact = np.stack([_zscore64(c) for c in channels[:-1]] + [np.zeros(channels[0].shape)], -1)
            assert np.abs(got - exact).max() <= min(JAX_ATOL, np.abs(want - exact).max())
        else:
            np.testing.assert_allclose(got, want, atol=JAX_ATOL)
        host, _ = load_multimodal_images(case, modalities=port.config.modalities, normalize=normalize,
                                         norm_percentiles=port.config.norm_percentiles)
        assert got.shape == host.shape
        np.testing.assert_allclose(got, host, atol=HOST_ATOL)
        assert np.abs(got[..., -1]).max() == 0  # the missing channel

    def test_bf16_wire(self, setup):
        """In bf16 the stack is the fp32 one rounded once."""
        case, pth = setup
        _, port = _predictors(pth, True)
        channels, _ = load_multimodal_raw(case, modalities=port.config.modalities)
        bf16 = Predictor(port.config.replace(compute_dtype="bfloat16"), pth, device="cpu")
        got = bf16._device_ingest_stack(channels)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, port._device_ingest_stack(channels).to(torch.bfloat16))

    def test_probs_match_jax_and_host_end_to_end(self, setup):
        case, pth = setup
        jax_p, port = _predictors(pth, True)
        _, port_host = _predictors(pth, False)
        probs, ref = port.predict_case(case)
        want, want_ref = jax_p.predict_case(case)
        host, _ = port_host.predict_case(case)
        assert ref.shape == want_ref.shape == probs.shape[:3]
        np.testing.assert_allclose(probs, np.asarray(want), atol=PROB_ATOL)
        np.testing.assert_allclose(probs, host, atol=HOST_ATOL)

    def test_tiled_case_passes_the_stack_through(self, setup):
        """Above the window (16³ windows over the 20³ case) the device stack
        is tiled as the host array is."""
        case, pth = setup
        jax_p, port = _predictors(pth, True, window_size=(16, 16, 16))
        probs, _ = port.predict_case(case)
        np.testing.assert_allclose(probs, np.asarray(jax_p.predict_case(case)[0]), atol=PROB_ATOL)

    def test_duplicate_strategy_parity(self, setup):
        case, pth = setup
        _, port_host = _predictors(pth, False, missing_strategy="duplicate")
        jax_p, port = _predictors(pth, True, missing_strategy="duplicate")
        probs, _ = port.predict_case(case)
        np.testing.assert_allclose(probs, port_host.predict_case(case)[0], atol=HOST_ATOL)
        np.testing.assert_allclose(probs, np.asarray(jax_p.predict_case(case)[0]), atol=PROB_ATOL)


@pytest.mark.parametrize("dtype", ["int16", ">i2", "uint16", "uint8", "float32", "float64"])
def test_raw_dtypes(setup, dtype):
    """Each raw dtype (uint16 and float64 converted to float32 on the host,
    big-endian to native order) normalizes as the host path does."""
    _, pth = setup
    _, port = _predictors(pth, True)
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 250, size=(12, 10, 8)).astype(dtype)
    got = port._device_ingest_stack([raw, None, None, None, None])[..., 0].numpy()
    np.testing.assert_allclose(got, normalize_intensity(raw.astype(np.float32), "percentile"), atol=HOST_ATOL)
    ref = port._device_ingest_stack([raw.astype(np.int16), None, None, None, None])[..., 0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_percentiles_above_2_24_voxels():
    """A 257×256×256 int16 volume (2**24 + 65,536 voxels, beyond
    ``torch.quantile``'s limit): the percentiles equal ``np.percentile``'s,
    and the normalized channel the host path's."""
    shape = (257, 256, 256)
    x = np.random.default_rng(2).normal(300, 80, size=shape).astype(np.int16)
    assert x.size > 2**24
    t = torch.from_numpy(x)
    with pytest.raises(RuntimeError):
        torch.quantile(t.float(), 0.5)
    got = percentiles(t, (1.0, 99.0)).numpy()
    np.testing.assert_allclose(got, np.percentile(x, (1.0, 99.0)), rtol=1e-6)
    norm = normalize_on_device(t, "percentile", (1.0, 99.0)).numpy()
    np.testing.assert_allclose(norm, normalize_intensity(x, "percentile", (1.0, 99.0)), atol=HOST_ATOL)


def test_server_reads_raw_on_the_prefetch_thread(setup, tmp_path):
    """Under device_ingest the server's host half is the raw channels; its
    masks equal the host-ingest server's where the host probability is
    decided (farther than 1e-2 from the threshold)."""
    case, pth = setup
    inbox = tmp_path / "in"
    shutil.copytree(case, inbox / "case000")
    config = get_config("quick", **CONFIG_ARGS)
    masks = {}
    for ingest in (False, True):
        server = PredictionServer(config.replace(device_ingest=ingest), pth, str(inbox), str(tmp_path / f"out{ingest}"),
                                  explicit=["device_ingest"], min_age=0.0, device="cpu")
        image, _ = server._load("case000")
        assert isinstance(image, list) == ingest
        assert server.run_once()["done"] == 1
        masks[ingest] = read_volume(str(tmp_path / f"out{ingest}" / "case000" / "segmentation.nii.gz")).data
    host_probs = Predictor(config, pth, device="cpu").predict_case(case)[0][..., 0]
    decided = np.abs(host_probs - config.threshold) > 1e-2
    np.testing.assert_array_equal(masks[True][decided], masks[False][decided])
