"""Port's weight bridge, BN fold and .pth handling against the JAX package:
pcmseg_tpu_torch/train/checkpoints.py, infer/fold_bn.py, infer/validate.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config
from pcmseg_tpu.infer.fold_bn import fold_batchnorm as jax_fold_batchnorm
from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train.checkpoints import params_to_torch_state_dict
from pcmseg_tpu_torch.infer.fold_bn import fold_batchnorm, has_batchnorm
from pcmseg_tpu_torch.infer.validate import adopt_checkpoint_config, load_model_state
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth, state_dict_from_jax_params


@pytest.fixture(scope="module")
def jax_tree():
    """Base-4 JAX params + non-trivial batch stats, as numpy trees."""
    model = JaxUNet3D(base_features=4, remat=False, dtype=jnp.float32)
    init = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, 16, 16, 16, 5)), train=False))
    v = jax.tree.map(np.array, jax.device_get(init(jax.random.key(5))))
    rng = np.random.default_rng(5)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.2, 2.0, size=a.shape).astype(np.float32), v["batch_stats"]
    )
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (
            rng.normal(1.0, 0.3, size=a.shape).astype(np.float32)
            if "norm" in str(path[-2])
            else a
        ),
        v["params"],
    )
    return params, stats


def _assert_same_state_dict(got, want, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0, err_msg=k)


def test_state_dict_from_jax_params_matches_exporter(jax_tree):
    params, stats = jax_tree
    _assert_same_state_dict(
        state_dict_from_jax_params(params, stats), params_to_torch_state_dict(params, stats)
    )


def test_state_dict_from_folded_jax_params_matches_exporter(jax_tree):
    folded = jax_fold_batchnorm(*jax_tree)
    sd = state_dict_from_jax_params(folded)
    _assert_same_state_dict(sd, params_to_torch_state_dict(folded))
    assert not has_batchnorm(sd)
    UNet3D(base_features=4, norm_layer="none").load_state_dict(sd, strict=True)


def test_fold_matches_jax_fold_then_export(jax_tree):
    params, stats = jax_tree
    got = fold_batchnorm(params_to_torch_state_dict(params, stats))
    want = params_to_torch_state_dict(jax_fold_batchnorm(params, stats))
    _assert_same_state_dict(got, want, atol=1e-6)
    UNet3D(base_features=4, norm_layer="none").load_state_dict(got, strict=True)


def test_folded_model_matches_batchnorm_model(jax_tree):
    sd = state_dict_from_jax_params(*jax_tree)
    bn = UNet3D(base_features=4, dtype=torch.float32).eval()
    bn.load_state_dict(sd, strict=True)
    folded = UNet3D(base_features=4, norm_layer="none", dtype=torch.float32).eval()
    folded.load_state_dict(fold_batchnorm(sd), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16, 16, 16, 5)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(folded(x).numpy(), bn(x).numpy(), atol=5e-4, rtol=1e-3)


def test_pth_round_trip_and_bare_state_dict(tmp_path, jax_tree):
    sd = state_dict_from_jax_params(*jax_tree)
    cfg = get_config(base_features=4).to_dict()
    path = save_pth(str(tmp_path / "sub" / "m.pth"), sd, cfg)
    got, snap = load_pth(path)
    _assert_same_state_dict(got, sd)
    assert snap["base_features"] == 4 and tuple(snap["modalities"]) == cfg["modalities"]
    torch.save(sd, tmp_path / "bare.pth")
    got, snap = load_pth(str(tmp_path / "bare.pth"))
    _assert_same_state_dict(got, sd)
    assert snap is None
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["m.pth"]  # no temp file left


def test_adopt_checkpoint_config(tmp_path, jax_tree):
    sd = state_dict_from_jax_params(*jax_tree)
    snap = get_config(base_features=4, normalize="zscore", target_size=(32, 32, 32)).to_dict()
    with_snap = save_pth(str(tmp_path / "a.pth"), sd, snap)
    cfg = adopt_checkpoint_config(get_config(), with_snap)
    assert (cfg.base_features, cfg.normalize, cfg.target_size) == (4, "zscore", (32, 32, 32))
    cfg = adopt_checkpoint_config(get_config(normalize="percentile"), with_snap, ["normalize"])
    assert cfg.normalize == "percentile"  # explicit flags win over the snapshot

    bare = str(tmp_path / "bare.pth")
    torch.save(sd, bare)
    assert adopt_checkpoint_config(get_config(), bare).normalize == "minmax"
    assert adopt_checkpoint_config(get_config(normalize="zscore"), bare, ["normalize"]).normalize == "zscore"

    model, loaded = load_model_state(adopt_checkpoint_config(get_config(), with_snap), with_snap)
    assert model.inc.conv[0].weight.device.type == "cpu"
    _assert_same_state_dict(loaded, sd)
    with pytest.raises(NotImplementedError, match=".pth"):
        adopt_checkpoint_config(get_config(), str(tmp_path / "orbax_dir"))
