"""pcmseg_tpu_torch/parallel against pcmseg_tpu/parallel and the loader's
process shards against the JAX loader's, on the CPU; then the collectives
on a 2-process gloo cluster whose workers are this file itself, started by
``subprocess`` (``python tests/test_torch_parallel.py PID PORT OUT``), each
with a timeout of its own:

  * ``exchange`` returns every contributed byte (−0.0, NaN payloads, bf16
    and uint8) unchanged;
  * ``all_reduce_sum``'s backward under ``backward_scale`` gives each rank
    the gradient of the global sum;
  * BatchNorm over two ranks' halves equals BatchNorm over the whole batch
    in one process: y, the statistics, dx, and dγ/dβ once summed over the
    ranks (fp32 sums in another order: rtol 1e-5, atol 1e-6);
  * a barrier on a second thread completes while the first thread is in
    an all-reduce.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("dp,sp,tp", [(-1, 1, 1), (2, 1, 1), (-1, 2, 1), (-1, 1, 3), (3, 1, 1), (9, 1, 1),
                                      (2, 2, 2), (-1, 2, 2)])
def test_make_mesh_rules_match_jax(world, dp, sp, tp):
    import jax

    from pcmseg_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from pcmseg_tpu_torch.parallel.sharding import make_mesh

    try:
        want = dict(jax_make_mesh(dp, sp, tp, devices=jax.devices()[:world]).shape)
    except ValueError:
        with pytest.raises(ValueError):
            make_mesh(dp, sp, tp, world=world)
        return
    assert make_mesh(dp, sp, tp, world=world).shape == want


@pytest.mark.parametrize("n,count", [(10, 3), (7, 4), (2, 4), (0, 2)])
def test_process_local_indices_match_jax(n, count):
    from pcmseg_tpu.parallel.multihost import process_local_indices as jax_indices
    from pcmseg_tpu_torch.parallel.multihost import process_local_indices

    idxs = list(range(100, 100 + n))
    shards = [process_local_indices(idxs, i, count) for i in range(count)]
    assert shards == [jax_indices(idxs, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == idxs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from pcmseg_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=7, shape=(12, 12, 12), seed=5)
    return root


@pytest.mark.parametrize("batch_size,pad_to,count", [(4, 4, 2), (3, 6, 3), (4, 4, 4)])
def test_loader_process_shards_match_jax(tree, batch_size, pad_to, count):
    """Each process's batches (shuffled, two epochs, the ragged tail padded)
    equal the JAX loader's ``process_shard`` batches byte for byte, and the
    processes' shards put together are the unsharded loader's batches."""
    from pcmseg_tpu.data.dataset import ProstateDataset as JaxDataset
    from pcmseg_tpu.data.loader import DataLoader as JaxLoader
    from pcmseg_tpu_torch.data.dataset import ProstateDataset
    from pcmseg_tpu_torch.data.loader import DataLoader

    kw = dict(data_dir=tree, target_size=(16, 16, 16))
    ds, jds = ProstateDataset(**kw), JaxDataset(**kw)
    whole = DataLoader(ds, batch_size=batch_size, shuffle=True, pad_to=pad_to, seed=3)
    whole_batches = [list(whole), list(whole)]
    per_process = []
    for pi in range(count):
        ours = DataLoader(ds, batch_size=batch_size, shuffle=True, pad_to=pad_to, seed=3,
                          process_shard=(pi, count))
        theirs = JaxLoader(jds, batch_size=batch_size, shuffle=True, pad_to=pad_to, seed=3,
                           process_shard=(pi, count))
        got = [list(ours), list(ours)]
        want = [list(theirs), list(theirs)]
        assert [len(e) for e in got] == [len(e) for e in want] == [2 if batch_size == 4 else 3] * 2
        for a, b in zip(sum(got, []), sum(want, [])):
            assert a["case_id"] == b["case_id"]
            np.testing.assert_array_equal(a["weight"], b["weight"])
            np.testing.assert_array_equal(a["image"], np.asarray(b["image"], np.float32))
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["image"].shape[0] == pad_to // count
        per_process.append(sum(got, []))
    for i, full in enumerate(sum(whole_batches, [])):
        parts = [p[i] for p in per_process]
        assert sum((p["case_id"] for p in parts), []) == full["case_id"]
        np.testing.assert_array_equal(np.concatenate([p["weight"] for p in parts]), full["weight"])
        # each process's batch carries the global batch's real samples
        assert all(p["n_real"] == full["weight"].sum() for p in parts)


def test_loader_shard_with_microbatches_follows_the_layout(tree):
    """With accum_steps the shard is the rank's rows in microbatch order:
    layout (a) interleaves them, layout (b) is a contiguous block."""
    from pcmseg_tpu_torch.data.dataset import ProstateDataset
    from pcmseg_tpu_torch.data.loader import DataLoader

    ds = ProstateDataset(data_dir=tree, target_size=(16, 16, 16))
    full = next(iter(DataLoader(ds, batch_size=4, shuffle=False, pad_to=4)))
    for accum, rows in ((2, [[0, 2], [1, 3]]), (4, [[0, 1], [2, 3]])):
        for pi in range(2):
            got = next(iter(DataLoader(ds, batch_size=4, shuffle=False, pad_to=4, process_shard=(pi, 2),
                                       accum_steps=accum)))
            assert got["case_id"] == [full["case_id"][r] for r in rows[pi]]


@pytest.mark.parametrize(
    "batch,data,processes,accum,want",
    [(2, 1, 1, 1, 2), (5, 1, 1, 2, 6), (6, 4, 4, 3, 12), (5, 2, 2, 1, 6), (4, 2, 2, 4, 4), (7, 4, 4, 1, 8),
     (1, 4, 4, 1, 4), (8, 2, 2, 1, 8)],
)
def test_pad_to_is_the_least_multiple_of_the_ranks_processes_and_accum(batch, data, processes, accum, want):
    """JAX's rule (``trainer.py:127-136``): the smallest multiple of
    lcm(dp, processes, accum_steps) that holds the batch; 6 / dp 4 / accum 3
    is JAX's own test case (``test_padded_batch_divisible_by_accum``)."""
    from pcmseg_tpu_torch.parallel.sharding import padded_batch_size

    assert padded_batch_size(batch, data, processes, accum) == want


def test_trainer_pads_by_the_rule(tmp_path, tree):
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.parallel.sharding import padded_batch_size
    from pcmseg_tpu_torch.train.trainer import Trainer

    config = get_config("quick", data_dir=tree, save_dir=str(tmp_path), base_features=4, compute_dtype="float32",
                        target_size=(16, 16, 16), batch_size=5, accum_steps=3, device_data_cache_gb=0.0)
    trainer = Trainer(config, device="cpu")
    assert trainer._pad_to == padded_batch_size(5, 1, 1, 3) == 6
    assert {b["image"].shape[0] for b in trainer.train_loader} == {6}


def test_local_rows_partition_each_microbatch():
    from pcmseg_tpu_torch.parallel.sharding import local_rows, microbatch_layout, owned_microbatches

    # (a): every rank holds its part of every microbatch, in microbatch order
    assert microbatch_layout(8, 2, 2) == "a"
    assert [local_rows(8, 2, 2, r) for r in range(2)] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    # (b): whole microbatches, a contiguous block of them per rank
    assert microbatch_layout(4, 4, 2) == "b"
    assert [local_rows(4, 4, 2, r) for r in range(2)] == [[0, 1], [2, 3]]
    assert list(owned_microbatches(4, 2, 1)) == [2, 3]
    # accum 1 is the contiguous slice of JAX's process_shard
    assert [local_rows(6, 1, 3, r) for r in range(3)] == [[0, 1], [2, 3], [4, 5]]
    for b, a, w in ((12, 3, 2), (12, 4, 4), (16, 4, 2), (8, 8, 4)):
        rows = sorted(sum((local_rows(b, a, w, r) for r in range(w)), []))
        assert rows == list(range(b))
    # (c) 4 ranks, accum 6: the padded batch of 12 has microbatches of 2;
    # gcd(4, 6) = 2 groups of q = 2 ranks, group j runs microbatches
    # 3j .. 3j + 2, each of its ranks one row of each
    assert microbatch_layout(12, 6, 4) == "c"
    rows = [local_rows(12, 6, 4, r) for r in range(4)]
    assert rows == [[0, 2, 4], [1, 3, 5], [6, 8, 10], [7, 9, 11]]
    for r in range(4):
        owned = list(owned_microbatches(6, 4, r, "c"))
        assert owned == [3 * (r // 2) + i for i in range(3)]
        group = rows[r - r % 2] + rows[r - r % 2 + 1]
        assert sorted(group) == [2 * j + k for j in owned for k in range(2)]  # every row of each, once


def test_shard_batch_slices_arrays_tensors_and_lists():
    import torch

    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch

    batch = {"image": np.arange(8), "weight": torch.arange(8.0), "case_id": list("abcdefgh"), "n_real": 7.0}
    got = shard_batch(batch, Mesh(2), rank=1, accum=2)
    assert got["image"].tolist() == [2, 3, 6, 7] and got["weight"].tolist() == [2.0, 3.0, 6.0, 7.0]
    assert got["case_id"] == list("cdgh") and got["n_real"] == 7.0


def test_unported_axes_and_tensor_parallel_specs_are_refused():
    """Every mesh axis is ported now: tensor parallelism's specs are JAX's
    rule by shape (tests/test_torch_tp.py holds them against JAX's), and a
    model with a model axis builds, with fp32 or 16-bit parameters, and
    with fp16 compute. What is still refused by name, where every entry
    point builds its model, is a compute or parameter dtype outside the
    ported ones."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel.sharding import param_spec

    assert param_spec((3, 3, 3, 8, 16), 1) == ()
    assert param_spec((3, 3, 3, 8, 16), 2) == (None, None, None, None, "model")
    assert param_spec((3, 3, 3, 8, 1), 2) == ()
    UNet3D.from_config(get_config(spatial_parallel=2, tensor_parallel=2), device="meta")
    model = UNet3D.from_config(get_config(tensor_parallel=2, param_dtype="bfloat16"), device="meta")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert UNet3D.from_config(get_config(tensor_parallel=2, compute_dtype="float16"), device="meta").dtype == torch.float16
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        UNet3D.from_config(get_config(tensor_parallel=2, compute_dtype="float64"), device="meta")


def test_one_process_group_initialises_once_and_needs_no_traffic():
    """A 1-process gloo group: a second ``initialize`` is a no-op, the
    barrier, ``establish_collectives`` and the state check complete alone,
    and ``shutdown`` leaves no group behind."""
    import torch.distributed as dist

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_state

    assert not dist.is_initialized() and multihost.process_count() == 1 and multihost.is_primary()
    multihost.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0, backend="gloo")
    try:
        multihost.initialize(f"localhost:{_free_port()}", num_processes=3, process_id=2)
        assert dist.get_world_size() == 1 and not multihost.is_multiprocess()
        multihost.establish_collectives()
        multihost.barrier("once")
        assert multihost.next_tag("t") == "t#0" and multihost.next_tag("t") == "t#1"
        shard_state(UNet3D(base_features=2, n_modalities=5), Mesh())
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_initialize_without_torchrun_environment_says_what_is_missing(monkeypatch):
    from pcmseg_tpu_torch.parallel import multihost

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"):
        multihost.initialize()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(pid: int, port: int, out: str) -> int:
    import torch
    import torch.distributed as dist

    from pcmseg_tpu_torch.ops.kernels.batchnorm import BatchNormTrain
    from pcmseg_tpu_torch.parallel import collectives, multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid, backend="gloo")
    result = {}
    # exchange: each rank owns one half of the bytes
    special = torch.tensor([-0.0, float("nan"), 1.5, -3.25e-39, float("inf"), 2.0 ** -130], dtype=torch.float32)
    buf = torch.zeros(2, 6)
    buf[pid] = special * (pid + 1)
    collectives.exchange(buf)
    want = torch.stack([special, special * 2])
    result["exchange_float"] = torch.equal(buf.view(torch.int32), want.view(torch.int32))
    bits = torch.arange(-32768, 32768, 7, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    bbuf = torch.zeros(2, bits.numel(), dtype=torch.bfloat16)
    bbuf[pid] = bits
    collectives.exchange(bbuf)
    result["exchange_bf16"] = torch.equal(bbuf.view(torch.int16), torch.stack([bits, bits]).view(torch.int16))

    # all_reduce_sum: d(Σ_ranks Σ x²)/dx = 2x on every rank
    x = (torch.arange(4.0) + pid).requires_grad_()
    with collectives.synchronized_batch():
        total = collectives.batch_sum((x * x).sum())
        (total * collectives.backward_scale()).backward()
    result["sum"] = float(total)
    result["grad_ok"] = torch.allclose(x.grad, 2 * x.detach())

    # BatchNorm over the ranks' halves against the whole batch in one process
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(4, 3, 5, 4, 6, generator=g) * 2 + 1
    dy_whole = torch.randn(whole.shape, generator=g)
    weight, bias = torch.randn(6, generator=g), torch.randn(6, generator=g)

    def run(xin, dy, world):
        xin = xin.clone().requires_grad_(True)
        w, b = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        y, mean, var = BatchNormTrain.apply(xin, w, b, 1e-5, world)
        y.backward(dy)
        return y.detach(), mean, var, xin.grad, w.grad, b.grad

    ref = run(whole, dy_whole, 1)
    half = slice(2 * pid, 2 * pid + 2)
    got = list(run(whole[half], dy_whole[half], 2))
    for i in (4, 5):  # dγ, dβ are this rank's sums; the gradient all-reduce adds them
        dist.all_reduce(got[i])
    refs = [ref[0][half], ref[1], ref[2], ref[3][half], ref[4], ref[5]]
    result["bn_max_err"] = [float((a - b).abs().max()) for a, b in zip(got, refs)]
    result["bn_ok"] = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in zip(got, refs))

    # a barrier on another thread while this one is inside an all-reduce
    done = []
    t = threading.Thread(target=lambda: (multihost.barrier("side"), done.append(1)))
    if pid == 1:
        t.start()
        big = torch.ones(1 << 20)
        dist.all_reduce(big)  # rank 0 joins it only after its own barrier
    else:
        t.start()
        t.join(timeout=60)
        big = torch.ones(1 << 20)
        dist.all_reduce(big)
    t.join(timeout=60)
    result["barrier_from_thread"] = bool(done) and float(big[0]) == 2.0
    with open(f"{out}.{pid}.json", "w") as f:
        json.dump(result, f)
    multihost.shutdown()
    return 0


def test_collectives_on_a_two_process_cluster(tmp_path):
    port, out = _free_port(), str(tmp_path / "result")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(port), out], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    results = [json.load(open(f"{out}.{pid}.json")) for pid in range(2)]
    for r in results:
        assert r["exchange_float"] and r["exchange_bf16"]
        assert r["sum"] == sum(v * v for v in range(4)) + sum(v * v for v in range(1, 5))
        assert r["grad_ok"]
        assert r["bn_ok"], r["bn_max_err"]
        assert r["barrier_from_thread"]


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
