"""Port's dataset and loader (data/dataset.py, data/loader.py) against the JAX
package's: the same batches for the same tree, seed and epochs, padding
included, and one ``.npz`` preprocessing cache read by both packages."""

import os

import ml_dtypes
import numpy as np
import pytest

from pcmseg_tpu.data.augment import Augmenter
from pcmseg_tpu.data.dataset import ProstateDataset as JaxDataset
from pcmseg_tpu.data.loader import DataLoader as JaxLoader
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu_torch.data import dataset as port_dataset
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.data.loader import DataLoader

TARGET = (16, 16, 16)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=5, shape=(18, 20, 17), seed=3,
                           drop_modalities={"case001": ["DWI"]})
    return root


def _datasets(root, cache_dir=None):
    kw = dict(data_dir=root, target_size=TARGET, cache_dir=cache_dir)
    return JaxDataset(**kw), ProstateDataset(**kw)


def test_discovery_and_cache_keys_match(tree, tmp_path):
    jax_ds, ds = _datasets(tree, str(tmp_path))
    assert ds.case_ids == jax_ds.case_ids and len(ds) == 5
    assert port_dataset.LABEL_DIR == "ROI(BPH+PCA)"
    for a, b in zip(ds.case_list, jax_ds.case_list):
        assert a.missing_modalities == b.missing_modalities
        assert ds._cache_key(a) == jax_ds._cache_key(b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_cache_written_by_one_package_is_read_by_the_other(tree, tmp_path, writer):
    jax_ds, ds = _datasets(tree, str(tmp_path))
    first, second = (jax_ds, ds) if writer == "jax" else (ds, jax_ds)
    written = [first.load_case(i) for i in range(len(first))]
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 5 and all(f.endswith(".npz") for f in files)
    for i, w in enumerate(written):
        r = second.load_case(i)
        np.testing.assert_array_equal(np.asarray(r["image"], np.float32), np.asarray(w["image"], np.float32))
        np.testing.assert_array_equal(r["label"], w["label"])
    assert sorted(os.listdir(tmp_path)) == files  # read, not rewritten


def test_fresh_preprocessing_matches_bf16_rounding(tree):
    jax_ds, ds = _datasets(tree)
    for i in range(len(ds)):
        got, want = ds.load_case(i), jax_ds.load_case(i)
        assert got["image"].dtype == np.float32 and want["image"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got["image"], want["image"].astype(np.float32))
        np.testing.assert_array_equal(got["label"], want["label"])


def test_bf16_helpers_round_to_nearest_even_like_ml_dtypes():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 100
    x[:4] = [1.00390625, 1.01171875, -2.0078125, 65504.0]  # ties
    want = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(port_dataset.bf16_round(x), want.astype(np.float32))
    np.testing.assert_array_equal(port_dataset.bf16_bits(port_dataset.bf16_round(x)), want.view(np.uint16))
    np.testing.assert_array_equal(port_dataset.from_bf16_bits(want.view(np.uint16)), want.astype(np.float32))


@pytest.mark.parametrize(
    "aug",
    [
        None,
        dict(flip=True, rot90=True, intensity_jitter=0.0),
        dict(flip=True, rot90=True, intensity_jitter=0.1),
    ],
    ids=["no_aug", "flip_rot90", "intensity"],
)
def test_loader_batches_match_jax(tree, aug):
    """Batch 2 over 4 indices with pad_to 3: shuffled order, padding weights
    and cycled samples; epochs 0 and 1, then epoch 1 again after set_epoch.
    Bitwise with no augmentation or flips/rotations alone; the intensity
    jitter rounds to bf16 after every operation in the JAX package and once
    here: within one bf16 ulp."""
    jax_ds, ds = _datasets(tree)
    kw = dict(batch_size=2, shuffle=True, indices=[0, 1, 3, 4], pad_to=3, seed=11, num_workers=2)
    ours = DataLoader(ds, augmenter=Augmenter(seed=5, **aug) if aug else None, **kw)
    theirs = JaxLoader(jax_ds, augmenter=Augmenter(seed=5, **aug) if aug else None, **kw)
    runs = []
    for loader in (ours, theirs):
        epochs = [list(loader), list(loader)]
        loader.set_epoch(1)
        epochs.append(list(loader))
        runs.append(epochs)
    for epoch, (got_e, want_e) in enumerate(zip(*runs)):
        assert len(got_e) == len(want_e) == 2
        for got, want in zip(got_e, want_e):
            assert got["case_id"] == want["case_id"]
            np.testing.assert_array_equal(got["weight"], want["weight"])
            np.testing.assert_array_equal(got["label"], want["label"])
            img = want["image"].astype(np.float32)
            if aug and aug["intensity_jitter"]:
                np.testing.assert_allclose(got["image"], img, rtol=2.0**-7, atol=1e-30)
            else:
                np.testing.assert_array_equal(got["image"], img)
    assert runs[0][1][0]["case_id"] == runs[0][2][0]["case_id"]  # set_epoch replays
    assert list(runs[0][0][1]["weight"]) == [1.0, 1.0, 0.0]
