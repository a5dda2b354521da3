"""Spatial parallelism in pcmseg_tpu_torch/parallel and the model, on the
CPU: the D-slab plans, the mesh's rank order against JAX's device order,
the rows each rank scores, the threads of a sharded Predictor; then one
4-process gloo cluster whose workers are this file itself, started by
``subprocess`` (``python tests/test_torch_spatial.py PID PORT OUT``) with a
timeout, each rank holding one D-slab, against the same computation on the
whole volume in one process:

  * ``halo_exchange`` and ``gather_d``, forward and backward, over the 4
    ranks and over a group of 2 of them (slabs of unequal length included);
  * the training 3³ conv on a slab with its halo (``hybrid_conv.halo_conv``)
    and its dx and dW, fp32, within 1e-6 of the largest value;
  * the base-4 model's forward and every parameter's gradient (summed over
    the ranks) in BatchNorm training mode: 16³ over 4 ranks (levels 3 and 4
    gathered whole), 18³ over 2 (an odd level D, gathered from level 2),
    32³ over 2 (every level sharded, with remat), and a GroupNorm model at
    16³ over 4, in float64 within 1e-9 of the largest value.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# (name, input D, ranks, norm layer, remat)
MODELS = (("d16_r4", 16, 4, "batch", False), ("d18_r2", 18, 2, "batch", False),
          ("d32_r2_remat", 32, 2, "batch", True), ("d16_r4_group", 16, 4, "group", False))
MODEL_RTOL = 1e-9
CONV_TOL = 1e-6


@pytest.mark.parametrize("depth,parts,slabs", [
    (16, 4, [[(0, 4), (4, 8), (8, 12), (12, 16)], [(0, 2), (2, 4), (4, 6), (6, 8)],
             [(0, 1), (1, 2), (2, 3), (3, 4)], None, None]),
    (18, 2, [[(0, 10), (10, 18)], [(0, 5), (5, 9)], None, None, None]),
    (32, 2, [[(0, 16), (16, 32)], [(0, 8), (8, 16)], [(0, 4), (4, 8)], [(0, 2), (2, 4)], [(0, 1), (1, 2)]]),
    (128, 4, [[(32 * r, 32 * r + 32) for r in range(4)], [(16 * r, 16 * r + 16) for r in range(4)],
              [(8 * r, 8 * r + 8) for r in range(4)], [(4 * r, 4 * r + 4) for r in range(4)],
              [(2 * r, 2 * r + 2) for r in range(4)]]),
    (23, 2, [[(0, 12), (12, 23)], [(0, 6), (6, 11)], [(0, 3), (3, 5)], None, None]),
])
def test_level_plans(depth, parts, slabs):
    """Level 0 deals whole voxel pairs out evenly (the last slab keeps an
    odd voxel); a level is sharded while the one above starts every slab
    at an even index; each sharded level's slabs tile its whole D."""
    from pcmseg_tpu_torch.parallel.sharding import d_slabs, level_plan

    plan = level_plan(depth, parts)
    got = [None if s is None else [tuple(b) for b in s] for s in plan.slabs]
    assert got == slabs
    assert list(plan.depths) == [depth >> k for k in range(5)]
    for level, s in enumerate(plan.slabs):
        if s is not None:
            assert s[0][0] == 0 and s[-1][1] == plan.depths[level]
            assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(s, s[1:] + ((s[-1][1], None),)))
    assert d_slabs(depth, parts) == slabs[0]
    with pytest.raises(ValueError):
        d_slabs(2 * parts - 1, parts)


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 8)])
def test_mesh_coordinates_follow_jax_device_order(data, spatial):
    """Rank r sits where JAX's ``make_mesh`` puts device r of its list."""
    import jax

    from pcmseg_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from pcmseg_tpu_torch.parallel.multihost import mesh_coordinates

    devices = jax.devices()[: data * spatial]
    grid = np.vectorize(lambda d: devices.index(d))(jax_make_mesh(data, spatial, 1, devices=devices).devices)
    for d in range(data):
        for s in range(spatial):
            assert mesh_coordinates(int(grid[d, s, 0]), data, spatial) == (d, s, 0)


def test_shard_batch_takes_rows_by_data_and_slabs_by_spatial_coordinate():
    import torch

    from pcmseg_tpu_torch.parallel.sharding import D_SLAB, Mesh, shard_batch

    image = torch.arange(4 * 16 * 2 * 2 * 1.0).reshape(4, 16, 2, 2, 1)
    batch = {"image": image, "label": image.clone(), "weight": torch.arange(4.0), "case_id": list("abcd")}
    mesh = Mesh(2, 2)
    for rank in range(4):
        got = shard_batch(batch, mesh, rank=rank)
        d, s = divmod(rank, 2)
        assert got["case_id"] == list("abcd")[2 * d: 2 * d + 2]
        assert torch.equal(got["weight"], torch.arange(4.0)[2 * d: 2 * d + 2])
        assert torch.equal(got["image"], image[2 * d: 2 * d + 2, 8 * s: 8 * s + 8])
        assert torch.equal(got["label"], got["image"]) and got[D_SLAB] == (8 * s, 8 * s + 8, 16)


class _Member:
    def __init__(self, rank):
        self.rank = rank


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_slab_targets_partition_every_level(parts):
    """Over the ranks, the rows each scores at every level (sharded or
    replicated) tile the level's D, and their labels are the whole
    volume's nearest-resized labels (``align_labels``), for D = 16..63."""
    import torch

    from pcmseg_tpu_torch.parallel.collectives import SpatialPlan
    from pcmseg_tpu_torch.parallel.sharding import level_plan
    from pcmseg_tpu_torch.train.steps import align_labels, slab_targets

    for depth in range(max(16, 2 * parts), 64):
        levels = level_plan(depth, parts)
        labels = torch.arange(depth).reshape(1, depth, 1, 1, 1).expand(1, depth, 2, 2, 1).contiguous()
        for level in range(4):
            dl = levels.depths[level]
            whole_out = torch.zeros(1, dl, 1, 1, 1)
            want = align_labels(whole_out, labels)
            rows, got = [], []
            for r in range(parts):
                plan = SpatialPlan(_Member(r), levels)
                s, e = plan.slab(level)
                out = whole_out[:, s:e]
                o, t = slab_targets(out, labels, plan, level)
                rows.append(o.shape[1])
                got.append(t)
            assert sum(rows) == dl, (depth, level)
            assert torch.equal(torch.cat(got, 1), want), (depth, level)


def test_local_group_collectives_match_one_thread():
    """A Predictor's shard threads: the halo exchange and the D gather of
    3 threads' slabs equal the whole volume's, and an all-reduce is the
    same sum on every thread; a failing thread aborts the others."""
    import threading

    import torch
    import torch.nn.functional as F

    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import level_plan

    x = torch.randn(2, 12, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    levels = level_plan(12, 3)
    group, out = collectives.LocalGroup(3, timeout=60), {}

    def run(r):
        plan = collectives.SpatialPlan(group.member(r), levels)
        s, e = plan.slab(0)
        out[r] = (collectives.halo_exchange(x[:, s:e], plan.comm), collectives.gather_d(x[:, s:e], plan, 0),
                  plan.comm.all_reduce(torch.full((2,), float(r + 1))))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    padded = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    for r, (s, e) in enumerate(levels.slabs[0]):
        halo, whole, total = out[r]
        assert torch.equal(halo, padded[:, s: e + 2]) and torch.equal(whole, x)
        assert torch.equal(total, torch.full((2,), 6.0))

    broken = collectives.LocalGroup(2, timeout=60)
    errors = []

    def fail():
        broken.abort()

    def wait():
        try:
            broken.member(1).all_gather(torch.zeros(1))
        except threading.BrokenBarrierError as e:
            errors.append(e)

    waiter = threading.Thread(target=wait)
    waiter.start()
    fail()
    waiter.join(timeout=60)
    assert not waiter.is_alive() and errors


# ---- the 4-process cluster -------------------------------------------------------------


def _reference_halo(whole, bounds, dys):
    """(extended slabs, the whole x's gradient) of the halo exchange on one process."""
    import torch
    import torch.nn.functional as F

    x = whole.clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    ext = [padded[:, s: e + 2] for s, e in bounds]
    sum((t * dy).sum() for t, dy in zip(ext, dys)).backward()
    return [t.detach() for t in ext], x.grad


def _collective_cases(result, comm, key, seed):
    """halo_exchange and gather_d on ``comm`` against one process."""
    import torch

    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import level_plan

    g = torch.Generator().manual_seed(seed)
    depth = 10 if comm.size == 4 else 12  # 10 over 4: slabs of 4, 2, 2, 2
    whole = torch.randn(2, depth, 3, 3, 2, generator=g, dtype=torch.float64)
    levels = level_plan(depth, comm.size)
    bounds = levels.slabs[0]
    dys = [torch.randn(2, e - s + 2, 3, 3, 2, generator=g, dtype=torch.float64) for s, e in bounds]
    dwholes = [torch.randn(whole.shape, generator=g, dtype=torch.float64) for _ in bounds]
    ext_ref, grad_ref = _reference_halo(whole, bounds, dys)
    plan = collectives.SpatialPlan(comm, levels)
    s, e = plan.slab(0)
    x = whole[:, s:e].clone().requires_grad_(True)
    ext = collectives.halo_exchange(x, comm)
    ext.backward(dys[comm.rank])
    result[f"{key}_halo_fwd"] = torch.equal(ext.detach(), ext_ref[comm.rank])
    result[f"{key}_halo_bwd"] = float((x.grad - grad_ref[:, s:e]).abs().max())
    x = whole[:, s:e].clone().requires_grad_(True)
    gathered = collectives.gather_d(x, plan, 0)
    gathered.backward(dwholes[comm.rank])
    result[f"{key}_gather_fwd"] = torch.equal(gathered.detach(), whole)
    result[f"{key}_gather_bwd"] = float((x.grad - sum(dwholes)[:, s:e]).abs().max())


def _conv_case(result, comm):
    """The training conv on a slab with its halo, fp32, against the whole."""
    import torch

    from pcmseg_tpu_torch.ops.hybrid_conv import conv3x3, halo_conv
    from pcmseg_tpu_torch.ops.kernels.conv3d import pack_weight
    from pcmseg_tpu_torch.parallel.sharding import d_slabs

    g = torch.Generator().manual_seed(7)
    whole = torch.randn(2, 16, 6, 6, 8, generator=g)
    weight = (torch.randn(16, 8, 3, 3, 3, generator=g) * 0.2).requires_grad_(True)
    bias = torch.randn(16, generator=g).requires_grad_(True)
    dy = torch.randn(2, 16, 6, 6, 16, generator=g)

    def run(x, d, sharded):
        x = x.clone().requires_grad_(True)
        y = (halo_conv(lambda t: conv3x3(t, weight, bias, pack_weight(weight.detach())), x, comm)
             if sharded else conv3x3(x, weight, bias, pack_weight(weight.detach())))
        weight.grad = bias.grad = None
        y.backward(d)
        return y.detach(), x.grad, weight.grad.clone(), bias.grad.clone()

    ref = run(whole, dy, False)
    s, e = d_slabs(16, comm.size)[comm.rank]
    got = list(run(whole[:, s:e], dy[:, s:e], True))
    for i in (2, 3):  # a slab's dW and db are its part of the sums
        comm.all_reduce(got[i])
    want = [ref[0][:, s:e], ref[1][:, s:e], ref[2], ref[3]]
    result["conv_err"] = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]


def _model_case(result, comm, name, depth, norm, remat):
    """The base-4 model on a slab against the whole volume in one process."""
    import re

    import torch

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import level_plan

    model = UNet3D(base_features=4, norm_layer=norm, dtype=torch.float64, remat=remat,
                   generator=torch.Generator().manual_seed(3)).double().train()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, depth, 16, 16, 5, generator=g, dtype=torch.float64)
    dy = torch.randn(2, depth, 16, 16, 1, generator=g, dtype=torch.float64)

    def grads():
        out = {k: p.grad.clone() for k, p in model.named_parameters()}
        model.zero_grad()
        return out

    ref = model(x)
    (ref * dy).sum().backward()
    ref_grads = grads()
    plan = collectives.SpatialPlan(comm, level_plan(depth, comm.size))
    s, e = plan.slab(0)
    with collectives.synchronized_batch(batch=comm), collectives.spatial(plan):
        y = model(x[:, s:e])
        (y * dy[:, s:e]).sum().backward()
    got = grads()
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    worst = 0.0
    for k, want in ref_grads.items():
        comm.all_reduce(got[k])
        if re.search(r"conv\.[03]\.bias$", k):
            # a bias the norm after it takes out (BatchNorm; GroupNorm of one
            # channel a group): its true gradient is 0
            worst = max(worst, float((got[k] - want).abs().max()) / scale)
        else:
            worst = max(worst, float(((got[k] - want).abs().max()) / want.abs().max()))
    result[f"{name}_fwd"] = float((y.detach() - ref[:, s:e]).abs().max() / ref.abs().max())
    result[f"{name}_grad"] = worst
    result[f"{name}_levels"] = [plan.sharded(level) for level in range(5)]


def _worker(pid: int, port: int, out: str) -> int:
    import torch
    import torch.distributed as dist

    from pcmseg_tpu_torch.parallel import collectives, multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=WORLD, process_id=pid, backend="gloo")
    pair_group = dist.new_group([0, 1])  # every process makes every group
    world = collectives.world_comm()
    pair = collectives.ProcessComm(pair_group, [0, 1]) if pid < 2 else None
    result = {}
    _collective_cases(result, world, "r4", 10)
    if pair is not None:
        _collective_cases(result, pair, "r2", 11)
    _conv_case(result, world)
    for name, depth, ranks, norm, remat in MODELS:
        comm = world if ranks == WORLD else pair
        if comm is not None:
            _model_case(result, comm, name, depth, norm, remat)
    with open(f"{out}.{pid}.json", "w") as f:
        json.dump(result, f)
    multihost.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial") / "result")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(port), out], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    results = []
    for pid in range(WORLD):
        with open(f"{out}.{pid}.json") as f:
            results.append(json.load(f))
    return results


@pytest.mark.parametrize("ranks", [2, 4])
def test_halo_exchange_and_d_gather_match_one_process(cluster, ranks):
    for r in cluster[:ranks]:
        key = f"r{ranks}"
        assert r[f"{key}_halo_fwd"] and r[f"{key}_gather_fwd"]
        assert r[f"{key}_halo_bwd"] == 0.0 and r[f"{key}_gather_bwd"] < 1e-12


def test_halo_conv_and_its_gradients_match_the_whole(cluster):
    for r in cluster:
        assert max(r["conv_err"]) <= CONV_TOL, r["conv_err"]


@pytest.mark.parametrize("name,depth,ranks,norm,remat", MODELS, ids=[m[0] for m in MODELS])
def test_model_on_slabs_matches_one_process(cluster, name, depth, ranks, norm, remat):
    want_levels = {16: [True, True, True, False, False], 18: [True, True, False, False, False],
                   32: [True] * 5}[depth]
    for r in cluster[:ranks]:
        assert r[f"{name}_levels"] == want_levels
        assert r[f"{name}_fwd"] <= MODEL_RTOL and r[f"{name}_grad"] <= MODEL_RTOL, (r[f"{name}_fwd"], r[f"{name}_grad"])


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
