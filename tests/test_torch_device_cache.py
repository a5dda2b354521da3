"""Port's device data cache (pcmseg_tpu_torch/data/device_cache.py) and the
trainer's cached paths, on the CPU.

The transforms are held against the JAX package's at given parameters (the
random draws cannot match: JAX draws from its own PRNG): the warp within
1e-5 with labels exact, the blur within 1e-6, and the 'center' crop rule
with its forced count. The random parts are held by their invariants, as
``tests/test_device_cache.py`` and ``tests/test_train_crop.py`` hold JAX's.
The trainer's cached paths are held against its streamed path: with
augmentation off a cached epoch equals a streamed one bit for bit.
"""

import io
from logging import StreamHandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.data import device_cache as jax_cache
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data import device_cache
from pcmseg_tpu_torch.data.loader import RamCaseCache
from pcmseg_tpu_torch.train.cv import CrossValidationTrainer
from pcmseg_tpu_torch.train.trainer import Trainer
from pcmseg_tpu_torch.utils.logging import get_logger

SIZE = 16


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- transforms at given parameters, against JAX ------------------------------------

WARPS = [(0.3, 0.9), (-0.5, 1.15), (0.0, 0.85), (0.7, 1.0), (0.2, 0.75)]  # (radians, zoom); zoom < 1 zooms out


@pytest.mark.parametrize("shape", [(16, 16, 16, 2), (10, 12, 18, 3)], ids=["cubic", "non_cubic"])
@pytest.mark.parametrize("angle,zoom", WARPS)
def test_affine_warp_matches_jax(shape, angle, zoom):
    rng = np.random.default_rng(hash((shape, angle, zoom)) % 2**32)
    img = rng.normal(size=shape).astype(np.float32)
    lab = rng.integers(0, 2, size=shape[:3] + (1,)).astype(np.uint8)
    want_i, want_l = jax_cache._affine_warp(jnp.asarray(img), jnp.asarray(lab), jnp.float32(angle), jnp.float32(zoom))
    got_i, got_l = device_cache._affine_warp(torch.from_numpy(img), torch.from_numpy(lab), angle, zoom)
    assert got_i.dtype == torch.float32 and got_l.dtype == torch.uint8
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("sigma", [0.0, 0.5, 0.8, 1.1, 2.0])
def test_separable_blur_matches_jax(sigma):
    img = np.random.default_rng(5).normal(size=(9, 8, 10, 3)).astype(np.float32)
    want = np.asarray(jax_cache._separable_blur(jnp.asarray(img), jnp.float32(sigma)))
    got = device_cache._separable_blur(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_affine_warp_90deg_is_rot90_and_identity_is_noop():
    """90° lands on integer coordinates, so the warp is exactly one of the
    two quarter turns; angle 0 and zoom 1 change nothing."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(4, 6, 6, 2)).astype(np.float32)
    lab = rng.integers(0, 2, size=(4, 6, 6, 1)).astype(np.uint8)
    out_i, out_l = device_cache._affine_warp(torch.from_numpy(img), torch.from_numpy(lab), np.pi / 2, 1.0)
    hits = [k for k in (1, 3) if np.allclose(out_i.numpy(), np.rot90(img, k=k, axes=(1, 2)), atol=1e-4)]
    assert len(hits) == 1
    np.testing.assert_array_equal(out_l.numpy(), np.rot90(lab, k=hits[0], axes=(1, 2)))
    img = rng.normal(size=(5, 7, 6, 2)).astype(np.float32)
    lab = rng.integers(0, 2, size=(5, 7, 6, 1)).astype(np.uint8)
    out_i, out_l = device_cache._affine_warp(torch.from_numpy(img), torch.from_numpy(lab), 0.0, 1.0)
    np.testing.assert_allclose(out_i.numpy(), img, atol=1e-5)
    np.testing.assert_array_equal(out_l.numpy(), lab)


def coord_volume(shape=(12, 16, 16), voxel=(10, 2, 13)):
    """Image whose channel 0 is the flat voxel coordinate (so a crop shows its
    offset) and a label with one foreground voxel."""
    coords = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    image = np.stack([coords, -coords], axis=-1)
    label = np.zeros(shape + (1,), np.uint8)
    label[voxel] = 1
    return image, label


def _offset(first, shape):
    return tuple(int(v) for v in np.unravel_index(int(first), shape))


@pytest.mark.parametrize("b,p,forced", [(4, 0.5, 2), (4, 0.33, 1), (2, 0.33, 1)],
                         ids=["B4_p0.5", "B4_p0.33", "padded_B2_p0.33"])
def test_center_crop_rule_and_forced_count_match_jax(b, p, forced):
    """'center': the first n = B - round(B(1 - p)) samples of the batch are
    centred on the foreground voxel, clip(v - c//2, 0, s - c), the rest
    uniform. B is the padded batch, as in JAX (``device_cache.py:518``): one
    real sample padded to 2 at p = 0.33 forces one, where its unpadded size
    would force none. The always-forced head of the batch over 12 draws is
    ``forced`` long in both packages."""
    shape, voxel, crop = (12, 16, 16), (10, 2, 13), (4, 8, 8)
    image, label = coord_volume(shape, voxel)
    images, labels = np.stack([image] * b), np.stack([label] * b)
    centred = tuple(int(np.clip(v - c // 2, 0, s - c)) for v, s, c in zip(voxel, shape, crop))
    heads = {}
    for name in ("jax", "port"):
        always = np.ones(b, bool)
        for seed in range(12):
            if name == "jax":
                out, lab = jax_cache.device_random_crop(images, labels, jax.random.key(seed), crop, oversample_fg=p)
                out, lab = np.asarray(out), np.asarray(lab)
            else:
                out, lab = device_cache.device_random_crop(torch.from_numpy(images), torch.from_numpy(labels),
                                                           _gen(seed), crop, oversample_fg=p)
                out, lab = out.numpy(), lab.numpy()
            hit = np.array([_offset(out[s, 0, 0, 0, 0], shape) == centred for s in range(b)])
            assert (lab[hit].reshape(hit.sum(), -1).sum(axis=1) == 1).all()
            always &= hit
        heads[name] = int(np.argmin(np.append(always, False)))
    assert heads == {"jax": forced, "port": forced}


# ---- invariants of the random transforms ------------------------------------------------

EXTENDED = dict(scale=0.15, rotate_deg=20.0, gamma=0.3, noise=0.1, blur_prob=0.5)


def _batch(shape, seed, dtype=torch.float32, classes=2):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    lab = torch.from_numpy(rng.integers(0, classes, size=shape[:-1] + (1,)).astype(np.uint8))
    return img, lab


@pytest.mark.parametrize("kw", [{}, EXTENDED], ids=["basic", "extended"])
def test_device_augment_shapes_dtypes_and_determinism(kw):
    img, lab = _batch((2, 8, 10, 10, 3), 2, classes=3)
    a_i, a_l = device_cache.device_augment(img, lab, _gen(11), **kw)
    b_i, b_l = device_cache.device_augment(img, lab, _gen(11), **kw)
    assert a_i.shape == img.shape and a_l.shape == lab.shape
    assert a_i.dtype == img.dtype and a_l.dtype == lab.dtype
    assert torch.equal(a_i, b_i) and torch.equal(a_l, b_l)
    assert set(np.unique(a_l.numpy())) <= {0, 1, 2}  # nearest-neighbour labels: no new values
    assert not torch.allclose(a_i, img)


def test_nonsquare_never_swaps_extents_and_flips_keep_the_label():
    img, lab = _batch((4, 4, 6, 8, 2), 1)
    for seed in range(6):
        a_i, a_l = device_cache.device_augment(img, lab, _gen(seed), intensity_jitter=0.0)
        assert a_i.shape == img.shape and a_l.shape == lab.shape
        # flips and rot90 permute voxels: the label stays binary, its count per sample unchanged
        assert set(np.unique(a_l.numpy())) <= {0, 1}
        assert torch.equal(a_l.sum(dim=(1, 2, 3, 4)), lab.sum(dim=(1, 2, 3, 4)))
        # and the image's voxels are the same multiset
        assert torch.equal(a_i.flatten(1).sort(dim=1).values, img.flatten(1).sort(dim=1).values)


def test_gamma_and_the_full_combination_stay_finite_in_bf16():
    """The gamma base is clamped at 1e-7, so the minimum voxel, which every
    sample has, gives no NaN; nor does any stage of the full combination."""
    x = torch.linspace(-3, 5, 2 * 3 * 4 * 5).reshape(2, 3, 4, 5, 1).to(torch.bfloat16)
    for g in (0.7, 1.0, 1.35):
        out = device_cache._gamma(x, g)
        assert torch.isfinite(out.float()).all()
        assert out.float().min() == x.float().min()  # the minimum maps to itself
    img, lab = _batch((2, 12, 12, 12, 3), 5, dtype=torch.bfloat16)
    for seed in range(8):
        a_i, _ = device_cache.device_augment(img, lab, _gen(seed), **{**EXTENDED, "blur_prob": 0.2})
        assert torch.isfinite(a_i.float()).all(), seed


@pytest.mark.parametrize("mode", ["center", "window"])
def test_oversampled_crops_contain_foreground_and_empty_labels_fall_back(mode):
    image, label = coord_volume()
    images, labels = torch.from_numpy(np.stack([image] * 4)), torch.from_numpy(np.stack([label] * 4))
    offsets = set()
    for seed in range(6):
        out, lab = device_cache.device_random_crop(images, labels, _gen(seed), (4, 8, 8), oversample_fg=1.0,
                                                   mode=mode)
        assert out.shape == (4, 4, 8, 8, 2) and lab.shape == (4, 4, 8, 8, 1)
        assert (lab.sum(dim=(1, 2, 3, 4)) == 1).all()
        assert torch.equal(out[..., 0], -out[..., 1])  # image channels cut at one offset
        offsets.update(_offset(v, (12, 16, 16)) for v in out[:, 0, 0, 0, 0])
    assert (len(offsets) > 1) == (mode == "window")  # 'center' has one place per voxel
    out, lab = device_cache.device_random_crop(images, torch.zeros_like(labels), _gen(0), (4, 8, 8),
                                               oversample_fg=1.0, mode=mode)
    assert lab.sum() == 0 and out.shape == (4, 4, 8, 8, 2)
    uniform = {_offset(v, (12, 16, 16)) for v in out[:, 0, 0, 0, 0]}
    assert len(uniform) > 1


# ---- the trainer's cached paths ----------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=6, shape=(18, 16, 17), seed=11)
    return root


def _config(tree, tmp_path, **kw):
    """6 cases: 5 train, 1 val (val_fraction 0.2), batch 2."""
    base = dict(data_dir=tree, save_dir=str(tmp_path / "ckpt"), cache_dir=str(tmp_path.parent / "preproc"),
                base_features=4, compute_dtype="float32", remat=False, target_size=(SIZE,) * 3, batch_size=2,
                num_epochs=2, early_stopping=False, seed=3, learning_rate=1e-3)
    base.update(kw)
    return get_config(**base)


def _partial(n_resident, size=SIZE):
    """A budget that holds ``n_resident`` cases and half of one more."""
    return (n_resident + 0.5) * device_cache.dataset_device_bytes(1, (size,) * 3, 5) / 1e9


# every transform, on 16³ crops of 20³ cases, a third of them forced onto foreground
AUG = dict(data_augmentation=True, aug_scale=0.15, aug_rotate_deg=15.0, aug_gamma=0.3, aug_noise=0.1,
           aug_blur_prob=0.5, target_size=(20,) * 3, train_crop=(16,) * 3, oversample_fg=0.33)


def _params(trainer):
    return list(trainer.state.model.state_dict().values())


def test_cached_epochs_equal_streamed_bitwise(tree, tmp_path):
    runs = {}
    for name, gb in (("streamed", 0.0), ("cached", 4.0)):
        trainer = Trainer(_config(tree, tmp_path / name, device_data_cache_gb=gb), device="cpu")
        assert (trainer._dcache is not None) == (name == "cached")
        if name == "cached":
            assert trainer._dcache["images"].dtype == torch.bfloat16
            assert trainer._dcache["labels"].dtype == torch.uint8
            assert trainer._dcache["images"].shape == (6, SIZE, SIZE, SIZE, 5)
        runs[name] = (trainer.train(), _params(trainer))
    (h_s, p_s), (h_c, p_c) = runs["streamed"], runs["cached"]
    assert h_c == h_s
    assert all(torch.equal(a, b) for a, b in zip(p_c, p_s))


def _spy(trainer):
    """Count the real samples each path trains on, and the cases."""
    seen = {"cached": [], "streamed": []}
    cached_step, stream_step = trainer._cached_train_step, trainer._train_step

    def spy_cached(state, images, labels, idx, weights, gen):
        rows = {r: c for c, r in trainer._dcache_row.items()}
        seen["cached"] += [rows[int(r)] for r, w in zip(idx, weights) if w > 0]
        return cached_step(state, images, labels, idx, weights, gen)

    def spy_stream(state, batch):
        seen["streamed"] += [c for c, w in zip(batch["case_id"], batch["weight"].tolist()) if w > 0]
        return stream_step(state, batch)

    trainer._cached_train_step, trainer._train_step = spy_cached, spy_stream
    return seen


def test_partial_cache_consumes_each_train_case_once_per_epoch(tree, tmp_path):
    """Budget for 3 cases: 3 of the 5 train cases resident, 2 train and the
    val case stream; each epoch trains on every train case exactly once,
    the 1 streamed batch among the 2 cached ones."""
    trainer = Trainer(_config(tree, tmp_path, device_data_cache_gb=_partial(3)), device="cpu")
    assert trainer._dcache_partial and trainer._dcache["images"].shape[0] == 3
    assert trainer._res_train == trainer.train_indices[:3] and trainer._str_train == trainer.train_indices[3:]
    assert trainer._res_val == [] and trainer._str_val == trainer.val_indices
    ids = trainer.dataset.case_ids
    for _ in range(2):
        seen = _spy(trainer)
        assert np.isfinite(trainer.train_epoch())
        assert sorted(seen["cached"]) == trainer._res_train
        assert sorted(seen["streamed"]) == sorted(ids[i] for i in trainer._str_train)


def test_partial_validation_equals_streamed_at_batch_1(tree, tmp_path):
    """3 val cases (val_fraction 0.5): streamed, 1 resident and 2 streamed
    (budget for 4), or all resident: the partition does not change the
    metrics."""
    results = []
    for gb in (0.0, _partial(4), 4.0):
        trainer = Trainer(_config(tree, tmp_path, device_data_cache_gb=gb, batch_size=1, val_fraction=0.5),
                          device="cpu")
        results.append(trainer.validate_epoch())
    for got in results[1:]:
        assert got == results[0]


def test_partial_cache_with_augmentation_is_deterministic_and_resumes_bitwise(tree, tmp_path):
    """The cached steps' draws come from (seed, epoch); the streamed
    remainder's from its loader's epoch, set on resume: a run killed after
    epoch 1 and resumed equals the uninterrupted one, and so does a second
    uninterrupted run."""
    config = _config(tree, tmp_path / "a", device_data_cache_gb=_partial(3, 20), **AUG)
    whole = Trainer(config, device="cpu")
    history = whole.train()
    again = Trainer(config.replace(save_dir=str(tmp_path / "b")), device="cpu")
    assert again.train() == history
    killed = config.replace(save_dir=str(tmp_path / "c"), num_epochs=1)
    Trainer(killed, device="cpu").train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device="cpu")
    assert resumed._epochs_run == 1 and resumed._stream_train_loader._epoch == 1
    assert resumed.train() == history
    assert all(torch.equal(a, b) for a, b in zip(_params(resumed), _params(whole)))


@pytest.mark.parametrize("kw,reason", [
    (dict(device_data_cache_gb=_partial(3), device_cache_partial=False), "partial cache off"),
    (dict(device_data_cache_gb=_partial(1)), "fewer than a batch"),
    (dict(device_data_cache_gb=0.0), "device data cache off"),
])
def test_below_the_budget_the_trainer_streams_and_says_so(tree, tmp_path, kw, reason):
    logger, out = get_logger("pcmseg.trainer"), io.StringIO()
    handler = StreamHandler(out)
    logger.addHandler(handler)
    try:
        trainer = Trainer(_config(tree, tmp_path, **kw), device="cpu")
    finally:
        logger.removeHandler(handler)
    assert trainer._dcache is None and not trainer._dcache_partial
    assert reason in out.getvalue() and "streams from the host" in out.getvalue()


def test_cross_validation_folds_share_one_upload(tree, tmp_path):
    config = _config(tree, tmp_path, n_splits=2, num_epochs=1)
    before = device_cache.uploads
    cv = CrossValidationTrainer(config, device="cpu")
    for k in range(2):
        cv.train_fold(k)
    assert device_cache.uploads - before == 1
    assert list(cv.dataset._device_cache_memo) == ["cpu"]


def test_memo_key_names_a_cuda_device_by_its_index(monkeypatch):
    """'cuda' and 'cuda:0' are one card and one memo entry (no card needed)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    keys = {device_cache._memo_key(torch.device(d)) for d in ("cuda", "cuda:0")}
    assert keys == {"cuda:0"}
    assert device_cache._memo_key(torch.device("cuda:1")) == "cuda:1"
    assert device_cache._memo_key(torch.device("cpu")) == "cpu"


def test_ram_memo_keeps_its_budget_and_hands_out_copies(tree, tmp_path):
    """The memo keeps int(stream_host_cache_gb·1e9 // per case) of the
    streamed cases, as JAX does; an epoch whose host blur (p = 1) writes into
    the float32 arrays it is handed leaves the memo's cases as decoded."""
    config = _config(tree, tmp_path, device_data_cache_gb=_partial(3), stream_host_cache_gb=_partial(1),
                     data_augmentation=True, aug_flip=False, aug_rot90=False, aug_intensity_jitter=0.0,
                     aug_blur_prob=1.0)
    trainer = Trainer(config, device="cpu")
    memo = trainer._stream_train_loader.dataset
    assert isinstance(memo, RamCaseCache) and memo._keep == {trainer._str_train[0]}
    case = trainer._str_train[0]
    first = memo.load_case(case)
    trainer.train_epoch()
    assert set(memo._memo) == {case}
    after = memo.load_case(case)
    np.testing.assert_array_equal(after["image"], first["image"])
    np.testing.assert_array_equal(after["image"], trainer.dataset.load_case(case)["image"])
    assert after["image"] is not memo.load_case(case)["image"]
