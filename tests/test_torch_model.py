"""Port's UNet3D (pcmseg_tpu_torch/models/unet3d.py) against the JAX UNet3D.

A JAX model's variables go through the JAX package's own exporter
(``params_to_torch_state_dict``) and load strictly into the port; both
run the same numpy input in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmseg_tpu.models import UNet3D as JaxUNet3D
from pcmseg_tpu.train.checkpoints import params_to_torch_state_dict
from pcmseg_tpu_torch.models.unet3d import GroupNorm, UNet3D, param_count
from pcmseg_tpu_torch.ops.kernels import conv3d

BASE = 4
# 16 x 24 x 20 floors to odd sizes on the way down (24 -> 3, 20 -> 5), so the
# decoder's pad-align runs on two axes
SHAPE = (2, 16, 24, 20, 5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_variables(norm_layer, seed):
    model = JaxUNet3D(base_features=BASE, norm_layer=norm_layer, remat=False, dtype=jnp.float32)
    init = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, 16, 16, 16, 5)), train=False))
    variables = jax.device_get(init(jax.random.key(seed)))
    if norm_layer == "batch":
        # non-trivial BN: random affine and running statistics
        rng = np.random.default_rng(seed)

        def perturb(tree, key):
            for k, v in tree.items():
                if isinstance(v, dict):
                    perturb(v, k)
                elif key.startswith("norm") and k in ("scale", "var"):
                    tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
                elif key.startswith("norm"):
                    tree[k] = rng.normal(0, 0.2, size=v.shape).astype(np.float32)

        variables = {k: dict(v) for k, v in variables.items()}
        variables = jax.tree.map(np.array, variables)
        perturb(variables["params"], "")
        perturb(variables["batch_stats"], "")
    return model, variables


@pytest.fixture(scope="module", params=["batch", "none"])
def pair(request):
    norm_layer = request.param
    jmodel, variables = _jax_variables(norm_layer, seed=3)
    x = np.random.default_rng(7).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    sd = params_to_torch_state_dict(variables["params"], variables.get("batch_stats"))
    model = UNet3D(base_features=BASE, norm_layer=norm_layer, dtype=torch.float32).eval()
    model.load_state_dict(sd, strict=True)
    return model, x, want


def test_logits_match_jax(pair):
    model, x, want = pair
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE[:4] + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_predict_and_inference_match_jax(pair):
    model, x, want = pair
    p_want = 1.0 / (1.0 + np.exp(-want))
    with torch.inference_mode():
        probs = model.predict(torch.from_numpy(x)).numpy()
        mask = model.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs, p_want, atol=1e-4)
    decided = np.abs(p_want - 0.5) > 1e-3
    np.testing.assert_array_equal(mask[decided], (p_want > 0.5)[decided].astype(np.float32))


def test_cpu_forward_launches_no_kernel(pair):
    model, x, _ = pair
    before = conv3d.launches
    with torch.inference_mode():
        model(torch.from_numpy(x))
    assert conv3d.launches == before


def test_base64_param_count_without_forward():
    assert param_count(UNet3D(base_features=64, device="meta")) == 90_311_361
    folded = UNet3D(base_features=64, norm_layer="none", device="meta")
    # folding drops gamma and beta of the 18 BN layers: 2 x 5,888 channels
    bn_channels = 2 * 64 * (1 + 2 + 4 + 8 + 16 + 8 + 4 + 2 + 1)
    assert bn_channels == 5_888
    assert param_count(folded) == 90_311_361 - 2 * bn_channels


def test_seeded_init_is_deterministic_kaiming_fan_out():
    a = UNet3D(base_features=4, generator=torch.Generator().manual_seed(0))
    b = UNet3D(base_features=4, generator=torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = UNet3D(base_features=64, generator=torch.Generator().manual_seed(1)).up4.conv.conv[0].weight
    assert abs(w.std().item() - (2.0 / (64 * 27)) ** 0.5) < 1e-3
    assert not a.inc.conv[0].bias.any()


def test_guards():
    model = UNet3D(base_features=4, dtype=torch.float32).eval()
    with pytest.raises(ValueError, match="input channels"):
        model(torch.zeros(1, 16, 16, 16, 4))
    with pytest.raises(ValueError, match=">= 16"):
        model(torch.zeros(1, 16, 8, 16, 5))
    # GroupNorm, ported since (tests/test_torch_groupnorm.py holds it against
    # flax): min(8, features) groups, no running statistics
    group = UNet3D(base_features=4, norm_layer="group")
    assert [m.num_groups for m in group.inc.conv if isinstance(m, GroupNorm)] == [4, 4]
    assert not [k for k in group.state_dict() if "running" in k]
    with pytest.raises(ValueError, match="norm_layer"):
        UNet3D(base_features=4, norm_layer="layer")
    with pytest.raises(ValueError, match=">= 16"):  # the guard holds in training mode too
        model.train()(torch.zeros(1, 16, 16, 8, 5))


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float16"])
def test_param_dtype_other_than_float32_is_refused_by_name(param_dtype):
    """JAX casts its params to ``param_dtype`` (``unet3d.py:529``), and so
    does the port now: every parameter (conv, transposed conv, head, norm
    scale and bias) in that dtype, BatchNorm's running statistics fp32 as
    ``norm.py:47-52`` keeps them, the same init values as the fp32 model
    rounded once. What is still refused by name is a dtype outside the
    ported ones."""
    from pcmseg_tpu_torch.core.config import get_config

    dtype = getattr(torch, param_dtype)
    model = UNet3D.from_config(get_config(base_features=4, param_dtype=param_dtype), device="meta")
    assert all(p.dtype == dtype for p in model.parameters())
    assert all(b.dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
               for k, b in model.named_buffers())
    fp32 = UNet3D.from_config(get_config(base_features=4), generator=torch.Generator().manual_seed(3))
    low = UNet3D.from_config(get_config(base_features=4, param_dtype=param_dtype),
                             generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(low.named_parameters(), fp32.parameters()):
        assert torch.equal(p, q.to(dtype)), name
    with pytest.raises(NotImplementedError, match="param_dtype='float64'"):
        UNet3D.from_config(get_config(base_features=4, param_dtype="float64"), device="meta")


def test_packed_weight_follows_loads_and_edits():
    model = UNet3D(base_features=4, norm_layer="none", dtype=torch.float32).eval()
    x = torch.ones(1, 16, 16, 16, 5)
    conv = model.inc.conv[0]
    with torch.no_grad():
        before = model(x)
        assert conv.packed_weight(torch.float32) is conv.packed_weight(torch.float32)  # cached
        conv.weight.mul_(2)  # an in-place edit repacks
        assert not torch.equal(model(x), before)
        model.load_state_dict(UNet3D(base_features=4, norm_layer="none").state_dict())
        np.testing.assert_array_equal(
            conv3d.unpack_weight(conv.packed_weight(torch.float32), 5).numpy(), conv.weight.numpy()
        )
    with torch.inference_mode():  # parameters made in inference mode have no version counter
        made_here = UNet3D(base_features=4, norm_layer="none", dtype=torch.float32).eval()
        assert made_here(x).shape == (1, 16, 16, 16, 1)
