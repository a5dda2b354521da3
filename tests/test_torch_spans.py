"""The program's spans (pcmseg_tpu_torch/utils/profiling.py) on the CPU: the
disabled span's cost, nesting, parents and keys across threads, the
buffer's bound, the clock against torch.profiler's, and the spans of a
cached train step and of a PredictionServer."""

import contextlib
import threading
import time
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data.device_cache import make_cached_train_step
from pcmseg_tpu_torch.data.nifti import write_nifti
from pcmseg_tpu_torch.infer.serve import PredictionServer
from pcmseg_tpu_torch.models.unet3d import UNet3D
from pcmseg_tpu_torch.train.checkpoints import save_pth
from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
from pcmseg_tpu_torch.utils import profiling
from pcmseg_tpu_torch.utils.profiling import drain_spans, span, start_spans


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and its buffer empty."""
    drain_spans()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    drain_spans()


def _by_id(records):
    return {r.id: r for r in records}


def test_disabled_span_reads_no_clock_allocates_nothing_and_opens_no_annotation(monkeypatch):
    class NoClock:
        def time_ns(self):
            raise AssertionError("a disabled span read the clock")

    class Refused:
        def __init__(self, *args):
            raise AssertionError("a disabled span made a span, an annotation or took the lock")

        __enter__ = __init__

    monkeypatch.setattr(profiling, "time", NoClock())
    monkeypatch.setattr(profiling, "record_function", Refused)
    monkeypatch.setattr(profiling, "_Span", Refused)
    monkeypatch.setattr(profiling._RECORDER, "lock", Refused.__new__(Refused))
    first = span("train.step", 0)
    assert span("serve.case", "c") is first  # one shared no-op context
    keys = list(range(4000))

    def peak(enter):
        """The most memory held at once over 4000 spans, above the start."""
        it = iter(keys)
        tracemalloc.start()
        try:
            with enter("train.forward", -1):
                pass
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            for k in it:
                with enter("train.forward", k):
                    pass
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    assert peak(span) <= peak(lambda name, key: first)  # no more than entering the shared context itself
    assert peak(lambda name, key: contextlib.nullcontext()) > peak(span)  # one object a span would show
    assert profiling._RECORDER.records == [] and profiling._RECORDER.dropped == 0


def test_spans_nest_with_parents_and_keys_on_each_thread():
    start_spans()
    barrier = threading.Barrier(2, timeout=30)

    def case(key):
        with span("serve.case", key):
            barrier.wait()  # both threads hold their outer span at once
            with span("serve.dispatch"):
                with span("serve.fetch", "own"):
                    pass
            barrier.wait()

    threads = [threading.Thread(target=case, args=(k,)) for k in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    records, dropped = drain_spans()
    assert dropped == 0 and len(records) == 6
    for key in ("a", "b"):
        (outer,) = [r for r in records if r.name == "serve.case" and r.key == key]
        (mid,) = [r for r in records if r.name == "serve.dispatch" and r.key == key]
        (inner,) = [r for r in records if r.name == "serve.fetch" and r.parent == mid.id]
        assert outer.parent is None and mid.parent == outer.id and inner.key == "own"
        assert outer.thread == mid.thread == inner.thread
        assert outer.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns <= mid.end_ns <= outer.end_ns
    assert len({r.thread for r in records}) == 2
    assert [r.name for r in records if r.thread == records[0].thread] == ["serve.fetch", "serve.dispatch",
                                                                           "serve.case"]


def test_buffer_counts_spans_past_capacity_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "capacity", 5)
    start_spans()
    for i in range(8):
        with span("train.step", i):
            pass
    records, dropped = drain_spans()
    assert [r.key for r in records] == [0, 1, 2, 3, 4] and dropped == 3
    assert drain_spans() == ([], 0)
    with span("train.step"):  # drained: off again
        pass
    assert drain_spans() == ([], 0)


def test_span_clock_brackets_the_profiler_events():
    """A span live because a CPU torch.profiler runs: every op event inside
    it lies inside its interval, on the same clock, and the span is the
    trace's user annotation of that name."""
    x = torch.randn(64, 64)
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("serve.dispatch", "c0"):
            (x @ x).relu().sum()
    after = time.time_ns()
    records, dropped = drain_spans()
    assert dropped == 0 and [(r.name, r.key) for r in records] == [("serve.dispatch", "c0")]
    (s,) = records
    assert before <= s.start_ns < s.end_ns <= after
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.name().startswith("aten::")]
    assert {"aten::mm", "aten::relu", "aten::sum"} <= {e.name() for e in ops}
    assert all(s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns for e in ops)
    (note,) = [e for e in events if e.is_user_annotation() and e.name() == "serve.dispatch"]
    assert s.start_ns <= note.start_ns() and note.start_ns() + note.duration_ns() <= s.end_ns


def _cached_step(seed):
    config = get_config(base_features=4, target_size=(16, 16, 16), batch_size=2, accum_steps=2,
                        compute_dtype="float32", remat=False, ema_decay=0.99, data_augmentation=False,
                        train_crop=None)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, config)
    step = make_cached_train_step(config, make_train_step(model, config))
    g = torch.Generator().manual_seed(seed + 1)
    images = torch.rand((4, 16, 16, 16, 5), generator=g).to(torch.bfloat16)
    labels = (torch.rand((4, 16, 16, 16, 1), generator=g) > 0.7).to(torch.uint8)
    return state, lambda idx: step(state, images, labels, idx, np.ones(2, np.float32), None)


def test_cached_train_step_spans():
    """A base-4, 16³ step in 2 microbatches: one gather, one step holding
    two forwards, two backwards and one optimizer, all keyed by the step."""
    state, run = _cached_step(0)
    run([0, 1])
    start_spans()
    run([2, 3])
    records, dropped = drain_spans()
    assert dropped == 0
    assert Counter(r.name for r in records) == {"train.gather": 1, "train.step": 1, "train.forward": 2,
                                                "train.backward": 2, "train.optimizer": 1}
    ids = _by_id(records)
    (step,) = [r for r in records if r.name == "train.step"]
    (gather,) = [r for r in records if r.name == "train.gather"]
    assert step.parent is None and gather.parent is None and gather.end_ns <= step.start_ns
    for r in records:
        assert r.key == 1  # the step's number: one step was taken before
        if r.name not in ("train.step", "train.gather"):
            assert ids[r.parent] is step and step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
    order = [r.name for r in sorted(records, key=lambda r: r.start_ns) if ids.get(r.parent) is step]
    assert order == ["train.forward", "train.backward"] * 2 + ["train.optimizer"]


def test_cached_train_step_bitwise_equal_with_spans_on_and_off():
    """Two steps from one seed with spans off and on: the same losses,
    gradients, parameters and EMA, bit for bit."""
    out = []
    for live in (False, True):
        state, run = _cached_step(3)
        if live:
            start_spans()
        losses = [run(idx)["loss"] for idx in ([0, 1], [2, 3])]
        records, _ = drain_spans()
        assert bool(records) == live
        model = state.model
        out.append((torch.stack(losses), [p.grad.clone() for p in model.parameters()],
                    [v.clone() for v in model.state_dict().values()], [e.clone() for e in state.ema.values()]))
    (l0, g0, p0, e0), (l1, g1, p1, e1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0 + e0, g1 + p1 + e1))


def _serve_tree(root, config, n_cases):
    rng = np.random.default_rng(0)
    for c in range(n_cases):
        for m in config.modalities:
            (root / f"case_{c}" / m).mkdir(parents=True)
            write_nifti(rng.normal(100, 20, size=(16, 16, 16)).astype(np.int16),
                        str(root / f"case_{c}" / m / "image.nii.gz"))


def test_server_spans_per_case(tmp_path):
    """3 cases through run_once: each case's spans on the serving thread
    under one ``serve.case``, its ``serve.decode`` on the prefetch thread
    with the same key, and one poll."""
    config = get_config(base_features=4)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0))
    pth = save_pth(str(tmp_path / "m.pth"), model.state_dict(), config.to_dict())
    _serve_tree(tmp_path / "in", config, 3)
    server = PredictionServer(config, pth, str(tmp_path / "in"), str(tmp_path / "out"), min_age=0.0, device="cpu")
    start_spans()
    assert server.run_once()["done"] == 3
    records, dropped = drain_spans()
    assert dropped == 0
    ids = _by_id(records)
    (poll,) = [r for r in records if r.name == "serve.poll"]
    cases = [r for r in records if r.name == "serve.case"]
    assert sorted(r.key for r in cases) == ["case_0", "case_1", "case_2"]
    for case in cases:
        children = [r for r in records if r.parent == case.id]
        assert Counter(r.name for r in children) == {"serve.prefetch_wait": 1, "serve.dispatch": 2, "serve.fetch": 1,
                                                     "serve.postprocess": 1, "serve.write": 1}
        assert all(r.key == case.key and r.thread == case.thread for r in children)
        (decode,) = [r for r in records if r.name == "serve.decode" and r.key == case.key]
        assert decode.parent is None and decode.thread != case.thread and decode.start_ns <= case.end_ns
    assert poll.thread == cases[0].thread and poll.end_ns <= min(r.start_ns for r in cases)
    assert all(r.parent is None or ids[r.parent].name == "serve.case" for r in records)


def test_spans_are_live_only_while_a_profiler_runs():
    with span("serve.poll"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("serve.poll", "in"):
            pass
    after = span("serve.poll")
    assert after is span("serve.case")  # the shared no-op again
    with after:
        pass
    assert [(r.name, r.key) for r in drain_spans().records] == [("serve.poll", "in")]


def test_one_rank_job_records_its_gradient_all_reduce_as_backward():
    """Under a process group the gradient all-reduce is one more
    ``train.backward`` of the step (a one-rank gloo group: an identity)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        state, run = _cached_step(5)
        start_spans()
        run([0, 1])
        records, dropped = drain_spans()
    finally:
        dist.destroy_process_group()
    ids = _by_id(records)
    backward = [r for r in records if r.name == "train.backward"]
    assert dropped == 0 and len(backward) == 3 and all(ids[r.parent].name == "train.step" for r in backward)
    last = max(backward, key=lambda r: r.start_ns)  # the all-reduce, after both microbatches
    assert all(r.end_ns <= last.start_ns for r in records if r.name == "train.forward")
