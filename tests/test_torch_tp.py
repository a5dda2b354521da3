"""Tensor parallelism's pieces in one process: JAX's rule by shape and its
map to the port's layouts, shard and gather of a state, the channel
gather's gradient, and whole sharded models against unsharded ones.

A group of threads stands in for the model group (``collectives.LocalGroup``,
one thread a rank: the same all-gathers and all-reduces as a process
group's). The models run in float64 at 16³, so a sharded forward and its
gradients must equal the unsharded ones to rounding (1e-9 of each leaf's
largest entry; the conv biases that the norm after them cancels, whose true
gradient is 0, held to 1e-9 absolute). The cluster tests against JAX are in
``tests/test_torch_tp_parity.py`` and ``tests/test_torch_tp_trainer.py``.
"""

import copy
import re
import threading

import numpy as np
import pytest
import torch

from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.parallel.collectives import ChannelShard, LocalGroup, gather_channels
from pcmseg_tpu_torch.parallel.sharding import local_payload, param_spec, shard_axes, shard_model, whole_payload

CANCELLED = re.compile(r"conv\.[03]\.bias$")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _on_threads(tp, fn):
    """[fn(comm) for each rank's comm of a ``tp``-thread model group]."""
    group, out = LocalGroup(tp, timeout=120), [None] * tp

    def run(r):
        try:
            out[r] = fn(group.member(r))
        except BaseException as e:
            group.abort()
            out[r] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for o in out:
        if isinstance(o, BaseException):
            raise o
    return out


@pytest.mark.parametrize("shape", [(3, 3, 3, 8, 8), (8,), (3, 3, 3, 5, 1), (), (3, 3, 3, 5, 64), (2, 2, 2, 12, 6),
                                   (1, 1, 1, 4, 3), (1, 1, 1, 4, 2), (12,), (6,)])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_param_spec_is_jax_rule(shape, tp):
    """JAX's own cases (``tests/test_train_steps.py:214-218``) and more."""
    from pcmseg_tpu.parallel.sharding import param_spec as jax_param_spec

    assert param_spec(shape, tp) == tuple(jax_param_spec(shape, tp))


@pytest.mark.parametrize("arch", [dict(), dict(norm_layer="group"), dict(n_classes=3), dict(n_classes=2),
                                  dict(deep_supervision=True), dict(base_features=6)],
                         ids=["bn", "group", "k3", "k2", "ds", "base6"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_axes_follow_jax_rule_through_the_layouts(arch, tp):
    """Every leaf of the JAX model, marked along its trailing axis (with the
    sign of JAX's ``param_spec`` answer for it) and crossed into the port's
    layout by ``state_dict_from_jax_params``: the port shards the torch
    axis the mark runs along exactly where JAX shards the JAX leaf."""
    import jax
    import jax.numpy as jnp

    from pcmseg_tpu.core.config import get_config
    from pcmseg_tpu.models import UNet3D as JaxUNet3D
    from pcmseg_tpu.parallel.sharding import param_spec as jax_param_spec
    from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params

    kw = {"base_features": 4, **arch}
    jmodel = JaxUNet3D.from_config(get_config(conv_lowering="lax", **kw))
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 16, 5)),
                                                train=False))

    def mark(leaf):
        # entry i along the trailing axis holds ±(i + 1), every other axis
        # constant; + where JAX shards the leaf
        sign = 1.0 if jax_param_spec(leaf.shape, tp) else -1.0
        return np.broadcast_to(sign * np.arange(1, leaf.shape[-1] + 1, dtype=np.float32), leaf.shape).copy()

    marked = jax.tree.map(mark, shapes)
    sd = state_dict_from_jax_params(marked["params"], marked.get("batch_stats"))
    model = UNet3D(**kw, device="meta")
    axes = shard_axes(model, tp)
    assert set(axes) == set(model.state_dict()) == set(sd)
    for k, t in sd.items():
        if t.dim() == 0:  # num_batches_tracked, which JAX does not have
            assert axes[k] is None, k
            continue
        assert (axes[k] is not None) == bool(t.flatten()[0] > 0), k
        if axes[k] is not None:
            varying = [d for d in range(t.dim()) if not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
            assert varying == [axes[k]], k
    if "n_classes" not in arch:
        assert axes["outc.weight"] is None and axes["inc.conv.0.weight"] == (0 if kw["base_features"] % tp == 0 else None)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_gives_back_the_state_bit_for_bit(tp):
    """A trained-looking payload (model, Adam moments, EMA) cut to each
    rank's shards and gathered back over the thread group is the payload."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.train.checkpoints import train_payload
    from pcmseg_tpu_torch.train.steps import create_train_state

    config = get_config(base_features=4, deep_supervision=True, ema_decay=0.99)
    model = UNet3D.from_config(config, deep_supervision=True, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, config)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    whole = train_payload(state)
    names = [k for k, _ in model.named_parameters()]
    axes = shard_axes(model, tp)
    parts = [local_payload(whole, axes, names, r, tp) for r in range(tp)]
    for k, a in axes.items():
        if a is not None:
            assert parts[1]["model"][k].shape[a] * tp == whole["model"][k].shape[a]
    back = _on_threads(tp, lambda comm: whole_payload(parts[comm.rank], axes, names, comm))
    for got in back:
        assert list(got["model"]) == list(whole["model"])
        for k, v in whole["model"].items():
            assert torch.equal(got["model"][k], v), k
        for k, v in whole["ema"].items():
            assert torch.equal(got["ema"][k], v), k
        for i, entry in whole["optimizer"]["state"].items():
            for key, v in entry.items():
                assert torch.equal(got["optimizer"]["state"][i][key], v), (names[i], key)
        assert got["optimizer"]["param_groups"] == whole["optimizer"]["param_groups"]


@pytest.mark.parametrize("consumer", ["sharded", "replicated"])
def test_channel_gather_gradient_against_autograd(consumer):
    """x → a Co-sharded 1×1 layer A → gather → a consumer B that is
    Co-sharded too or whole on every rank → loss. The gradients of x and of
    A's and B's weights equal autograd's of the unsharded function: a sum
    missing where B is sharded, or made where B is whole, is off by tp."""
    tp = 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, dtype=torch.float64, generator=g)
    wa = torch.randn(6, 8, dtype=torch.float64, generator=g)
    wb = torch.randn(4 if consumer == "sharded" else 3, 6, dtype=torch.float64, generator=g)
    up = torch.randn(3, wb.shape[0], dtype=torch.float64, generator=g)

    def loss(x, wa, wb):
        return ((torch.tanh(x @ wa.T) @ wb.T) * up).sum()

    xs, was, wbs = (t.clone().requires_grad_() for t in (x, wa, wb))
    loss(xs, was, wbs).backward()

    def rank(comm):
        a, b = ChannelShard(comm, 6, True), ChannelShard(comm, wb.shape[0], consumer == "sharded")
        lo, hi = a.span
        xr = x.clone().requires_grad_()
        war = wa[lo:hi].clone().requires_grad_()
        blo, bhi = b.span
        wbr = wb[blo:bhi].clone().requires_grad_()
        h = torch.tanh(a.input(xr, 8) @ war.T)  # this rank's channels of A's output
        y = b.input(h, 6) @ wbr.T  # gathered, then B's shard (or all of B)
        y = b.whole(y, wb.shape[0])
        (y * up).sum().backward()
        return xr.grad, war.grad, wbr.grad

    got = _on_threads(tp, rank)
    for gx, _, _ in got:
        np.testing.assert_allclose(gx.numpy(), xs.grad.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(torch.cat([r[1] for r in got]).numpy(), was.grad.numpy(), rtol=1e-12, atol=1e-12)
    wb_grad = torch.cat([r[2] for r in got]) if consumer == "sharded" else got[0][2]
    np.testing.assert_allclose(wb_grad.numpy(), wbs.grad.numpy(), rtol=1e-12, atol=1e-12)
    # the gather alone: the shards in rank order, forward
    parts = _on_threads(tp, lambda comm: gather_channels(torch.full((2, 3), float(comm.rank)), comm))
    assert torch.equal(parts[0], parts[1]) and parts[0][0].tolist() == [0, 0, 0, 1, 1, 1]


ARCHS = {
    "bn_tp2": (2, dict()),
    "bn_tp4": (4, dict()),
    "bn_remat_tp2": (2, dict(remat=True)),
    "k3_group_tp2": (2, dict(norm_layer="group", n_classes=3)),
    "group_spans_tp2": (2, dict(norm_layer="group", group_norm_groups=1)),
    "group_spans_tp4": (4, dict(norm_layer="group", group_norm_groups=2)),
    "base6_tp4": (4, dict(base_features=6)),
    "ds_tp2": (2, dict(deep_supervision=True)),
    "k2_tp2": (2, dict(n_classes=2)),
}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_sharded_model_equals_unsharded(name):
    """Forward and backward of a base-4 model, sharded over the thread group
    (BatchNorm with its statistics over the rank's own batch, the channel
    shards gathered where a layer reads them), against the unsharded model
    in float64: the logits (every head's), then every gradient, gathered
    from the shards, and each replicated leaf's gradient the same on every
    rank. ``group_spans``: GroupNorm groups that span the shards; ``base6``:
    a replicated level 1 and ``up4`` between sharded levels; ``k2``: a
    sharded head."""
    tp, kw = ARCHS[name]
    kw = {"base_features": 4, **kw}
    base = UNet3D(dtype=torch.float64, generator=torch.Generator().manual_seed(0), **kw).double().train()
    with torch.no_grad():
        for p in base.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()), dtype=p.dtype) * 0.1)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 16, 5, dtype=torch.float64, generator=g)
    seeds = []

    def heads(out):
        return [out[0], *out[1]] if isinstance(out, tuple) else [out]

    def objective(model):
        outs = heads(model(x))
        if not seeds:
            seeds.extend(torch.randn(o.shape, dtype=o.dtype, generator=g) for o in outs)
        total = sum((o * s).sum() for o, s in zip(outs, seeds))
        total.backward()
        return [o.detach() for o in outs]

    ref = copy.deepcopy(base)
    want_out = objective(ref)
    want = {k: p.grad for k, p in ref.named_parameters()}

    def rank(comm):
        model = copy.deepcopy(base)
        axes = shard_model(model, comm)
        outs = objective(model)
        return axes, outs, {k: p.grad for k, p in model.named_parameters()}

    got = _on_threads(tp, rank)
    axes = got[0][0]
    assert any(a is not None for a in axes.values())
    for _, outs, _ in got:
        for o, w in zip(outs, want_out):
            np.testing.assert_allclose(o.numpy(), w.numpy(), rtol=0, atol=1e-12)
    for k, w in want.items():
        parts = [r[2][k] for r in got]
        if axes[k] is None:
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), k
            g_k = parts[0]
        else:
            g_k = torch.cat(parts, axes[k])
        # a bias that the norm after it cancels has a gradient of rounding only
        scale = max(float(w.abs().max()), 1.0 if CANCELLED.search(k) else 0.0)
        assert float((g_k - w).abs().max()) <= 1e-9 * scale, k


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_kernel_shapes_of_the_flagship_shards(tp):
    """At base 64 every 3³ conv's output shard at tp 2, 4 and 8 is a
    multiple of 8 channels (B1 forward and B2 take Co % 8 == 0; B1 as dx
    takes the shard as its Ci, zero-padded to 64 by ``ci_pad``); at 16 the
    first level's 4 channels raise by name before any kernel runs."""
    from pcmseg_tpu_torch.models.unet3d import Conv3x3
    from pcmseg_tpu_torch.ops.kernels.conv3d import ci_pad

    model = UNet3D(base_features=64, device="meta")

    class Comm:
        size, rank = tp, 0

    if tp == 16:
        with pytest.raises(ValueError, match="tensor_parallel=16: inc.conv.0 would hold 4"):
            shard_model(model, Comm())
        return
    shard_model(model, Comm())
    for m in model.modules():
        if isinstance(m, Conv3x3):
            co, ci = m.weight.shape[:2]
            assert co % 8 == 0 and ci_pad(co) in (8, 64 * -(-co // 64)) and (ci <= 8 or ci % 64 == 0)


@pytest.mark.parametrize("tp,base", [(2, 4), (4, 6)])
def test_sharded_global_norm_is_the_whole_gradient_norm(tp, base):
    """The clip's norm on a sharded model (``steps.sharded_global_norm``):
    the sharded leaves' squares summed over the model group, the replicated
    ones (``outc``; at base 6 over 4 also level 1 and ``up4.up``) counted
    once: the norm of the whole gradient on every rank. A replicated leaf
    counted tp times, or a shard's squares left out, is off by far more
    than the 1e-12 held here."""
    from pcmseg_tpu_torch.train.steps import global_norm, sharded_global_norm

    base_model = UNet3D(base_features=base, generator=torch.Generator().manual_seed(0)).double()
    g = torch.Generator().manual_seed(2)
    for p in base_model.parameters():
        p.grad = torch.randn(p.shape, dtype=p.dtype, generator=g)
    want = float(global_norm([p.grad for p in base_model.parameters()]))
    assert sharded_global_norm(base_model) is None

    def rank(comm):
        model = copy.deepcopy(base_model)
        axes = shard_model(model, comm)
        for k, p in model.named_parameters():  # this rank's slice of the whole gradient
            whole = dict(base_model.named_parameters())[k].grad
            a = axes[k]
            p.grad = whole if a is None else whole.narrow(a, comm.rank * p.shape[a], p.shape[a]).clone()
        return float(sharded_global_norm(model))

    got = _on_threads(tp, rank)
    assert len(set(got)) == 1
    assert abs(got[0] - want) <= 1e-12 * want
