#!/usr/bin/env python3
"""The JAX package's gradient of the training loss on several ('data',
'spatial') meshes against its one-device gradient, on the CPU; with
``--model``, on ('data', 'spatial', 'model') meshes with a model axis.

    JAX_PLATFORMS=cpu python tools/jax_spatial_grads.py [--model]

A base-4 BatchNorm U-Net from ``init`` at 32³, a batch of 4 seeded
samples, the Dice loss in train mode; for each mesh over virtual CPU
devices (the batch sharded by ``parallel.sharding.shard_batch``): the loss,
the global norm of the gradient, and the largest difference of each kind
of leaf (conv kernels, BatchNorm scales) from the one-device gradient,
over that leaf's largest entry. Prints one line per mesh. With
``--model`` the meshes are (1, 1, 1), (1, 1, 2), (1, 1, 4), (2, 1, 2),
(1, 2, 2) and (2, 2, 2), and the params and the BatchNorm statistics are
placed on each as the JAX trainer places them (``shard_state``: each leaf
by ``param_spec``, its output channels over 'model' where they divide).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from __graft_entry__ import force_host_device_count_flags  # noqa: E402

os.environ["XLA_FLAGS"] = force_host_device_count_flags(os.environ.get("XLA_FLAGS", ""), 8)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pcmseg_tpu.core.config import get_config  # noqa: E402
from pcmseg_tpu.models import UNet3D  # noqa: E402
from pcmseg_tpu.ops.losses import make_loss_fn  # noqa: E402
from pcmseg_tpu.parallel.sharding import make_mesh, shard_batch, shard_state  # noqa: E402

SIZE = 32
MESHES = ((1, 1, 1), (2, 1, 1), (4, 1, 1), (1, 2, 1), (2, 2, 1), (1, 4, 1))
MODEL_MESHES = ((1, 1, 1), (1, 1, 2), (1, 1, 4), (2, 1, 2), (1, 2, 2), (2, 2, 2))


def main() -> int:
    model = UNet3D.from_config(get_config(conv_lowering="lax", base_features=4, remat=False, compute_dtype="float32"))
    variables = jax.jit(lambda k: model.init({"params": k}, jnp.zeros((1, SIZE, SIZE, SIZE, 5)), train=False))(
        jax.random.key(0))
    rng = np.random.default_rng(1)
    image = rng.normal(size=(4, SIZE, SIZE, SIZE, 5)).astype(np.float32)
    label = (rng.random((4, SIZE, SIZE, SIZE, 1)) > 0.7).astype(np.float32)
    loss_fn = make_loss_fn("dice")

    def loss(params, stats, x, y):
        out, _ = model.apply({"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return loss_fn(out, y)

    with_model = sys.argv[1:] == ["--model"]
    ref = None
    for dp, sp, tp in MODEL_MESHES if with_model else MESHES:
        mesh = make_mesh(dp, sp, tp, devices=jax.devices()[: dp * sp * tp])
        batch = shard_batch({"x": image, "y": label}, mesh)
        params, stats = variables["params"], variables["batch_stats"]
        if with_model:  # placed as the trainer places its state
            params, stats = shard_state((params, stats), mesh)
        value, grads = jax.jit(jax.value_and_grad(loss))(params, stats, batch["x"], batch["y"])
        leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(grads)}
        norm = float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in leaves.values())))
        if ref is None:
            ref = leaves
        worst = {}
        for kind, pick in (("conv kernels", "['kernel']"), ("BN scales", "['scale']")):
            worst[kind] = max(float(np.abs(v - ref[k]).max() / np.abs(ref[k]).max())
                              for k, v in leaves.items() if k.endswith(pick))
        print(f"mesh data {dp} x spatial {sp} x model {tp}: loss {float(value)!r}, grad norm {norm!r}, largest difference "
              f"from one device over the leaf's largest entry: "
              + ", ".join(f"{kind} {w:.3g}" for kind, w in worst.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
