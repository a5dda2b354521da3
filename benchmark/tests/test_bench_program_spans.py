"""The program's spans as the benchmark reads them (``lib/program_spans.py``):
each operation put down to the span open at its launch, idle gaps and the
host's waits by span, and each reader of a ``program_span`` metric on
synthetic readings."""

import json
import threading
from types import SimpleNamespace

import pytest

from benchmark.lib import harness, program_spans
from benchmark.lib.program_spans import DeviceActivity, Op, attribute, idle_by_span
from benchmark.lib.trace import DeviceTrace
from pcmseg_tpu_torch.utils.profiling import Drained, SpanRecord, drain_spans, span, start_spans

MAIN, AUTOGRAD, PREFETCH = 0x7F0000001111, 0x7F0000002222, 0x7F0000003333
M = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def rec(i, name, a, b, thread=MAIN, parent=None, key=None):
    return SpanRecord(i, name, a, b, thread, parent, key)


def cupti(thread):
    """A thread id as CUPTI gives it: the low 32 bits, signed."""
    t = thread & 0xFFFFFFFF
    return t - (1 << 32) if t >= 1 << 31 else t


# one train step on the main thread: forward, backward (launched by the autograd thread), optimizer
STEP = [rec(0, "train.gather", 0, 10, key=0), rec(1, "train.step", 20, 100, key=0),
        rec(2, "train.forward", 21, 40, parent=1, key=0), rec(3, "train.backward", 41, 80, parent=1, key=0),
        rec(4, "train.optimizer", 81, 99, parent=1, key=0)]


def test_operations_go_to_the_span_open_at_their_launch():
    ops = [Op(12, 30, "gather", 1, 7), Op(30, 50, "conv", 2, 7), Op(50, 60, "conv_dx", 3, 7),
           Op(60, 65, "reduce", 4, 7), Op(90, 95, "adam", 5, 7), Op(120, 130, "late", 6, 7)]
    launches = {1: (5, cupti(MAIN)), 2: (25, cupti(MAIN)),
                3: (45, cupti(AUTOGRAD)),  # the autograd thread has no span: matched by time
                5: (85, cupti(MAIN)), 6: (110, cupti(MAIN))}  # 4: no launch recorded
    att = attribute(DeviceActivity(ops, launches), STEP)
    assert [s.name if s else None for s in att.spans] == ["train.gather", "train.forward", "train.backward",
                                                          "train.backward", "train.optimizer", None]
    assert att.how == ["thread", "thread", "time", "stream", "thread", "none"]
    assert att.device_s(0, 200) == pytest.approx({"train.gather": 18e-9, "train.forward": 20e-9,
                                                  "train.backward": 15e-9, "train.optimizer": 5e-9, "none": 10e-9})
    assert att.device_s_by_rule(0, 200) == pytest.approx({"thread": 43e-9, "time": 10e-9, "stream": 5e-9,
                                                          "none": 10e-9})
    assert att.device_s(35, 55) == pytest.approx({"train.forward": 15e-9, "train.backward": 5e-9})
    assert att.top_ops(0, 200)["train.backward"] == [("conv_dx", pytest.approx(10e-9)),
                                                     ("reduce", pytest.approx(5e-9))]


def test_the_launching_threads_own_span_wins_over_another_threads():
    """A case's dispatch on the serving thread while the prefetch thread
    decodes the next case (started later): the launch goes to the dispatch."""
    spans = [rec(0, "serve.case", 0, 100, key="a"), rec(1, "serve.dispatch", 10, 90, parent=0, key="a"),
             rec(2, "serve.decode", 20, 80, thread=PREFETCH, key="b")]
    att = attribute(DeviceActivity([Op(40, 60, "conv", 1, 7)], {1: (30, cupti(MAIN))}), spans)
    assert att.spans == [spans[1]] and att.how == ["thread"]
    # from a thread with no span the latest started open span wins
    att = attribute(DeviceActivity([Op(40, 60, "conv", 1, 7)], {1: (30, cupti(AUTOGRAD))}), spans)
    assert att.spans == [spans[2]] and att.how == ["time"]


def test_idle_gaps_go_to_what_the_pacing_thread_was_doing():
    spans = STEP + [rec(5, "serve.decode", 0, 200, thread=PREFETCH)]
    gaps = [(15, 18), (38, 43), (99, 110), (150, 160)]
    # (15, 18): between the gather and the step; (38, 43): the end of the forward, the step
    # between its children, the backward; (99, 110): the step after its optimizer, then nothing on MAIN
    assert idle_by_span(gaps, spans, MAIN) == pytest.approx(
        {"serve.decode": 3e-9 + 10e-9 + 10e-9, "train.forward": 2e-9, "train.step": 1e-9 + 1e-9,
         "train.backward": 2e-9})
    assert idle_by_span(gaps, STEP) == pytest.approx(  # without a thread: by each gap's start alone
        {"none": 3e-9 + 10e-9, "train.forward": 5e-9, "train.step": 11e-9})


def test_device_activity_keeps_each_operations_earliest_host_event():
    def ev(name, device, start, dur, corr, res, note=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: SimpleNamespace(name=device),
                               start_ns=lambda: start, duration_ns=lambda: dur, correlation_id=lambda: corr,
                               device_resource_id=lambda: res, is_user_annotation=lambda: note)

    events = [ev("cudaLaunchKernel", "CPU", 100, 50, 34, -5), ev("Lazy Function Loading", "CPU", 110, 20, 34, 0),
              ev("kernel", "CUDA", 160, 10, 34, 7), ev("memset", "CUDA", 120, 5, 40, 7),
              ev("note", "CUDA", 100, 100, 0, 7, note=True), ev("cudaMalloc", "CPU", 90, 5, 33, -5),
              ev("cudaStreamSynchronize", "CPU", 30, 40, 35, cupti(MAIN)),
              ev("cudaMemcpyAsync", "CPU", 85, 10, 36, cupti(AUTOGRAD))]
    act = DeviceActivity.from_events(events)
    assert act.ops == [Op(120, 125, "memset", 40, 7), Op(160, 170, "kernel", 34, 7)]
    assert act.launches == {34: (100, -5)}
    assert act.waits == [(30, 70, "cudaStreamSynchronize", cupti(MAIN)), (85, 95, "cudaMemcpyAsync", cupti(AUTOGRAD))]
    # the first inside the forward on its own thread; the copy from a thread with no span goes by time
    waits = act.waits + [(150, 160, "cudaDeviceSynchronize", cupti(MAIN))]
    assert program_spans.wait_spans(waits, STEP) == ["train.forward", "train.optimizer", "none"]


def readings(spans, dropped=0, start=0, end=1000, **counters):
    r = harness.Readings(window_start_ns=start, window_end_ns=end, counters=counters)
    r.program_spans = Drained(spans, dropped)
    return r


def ms(a, b):
    return int(a * 1e6), int(b * 1e6)


SERVED = [rec(0, "serve.poll", *ms(0, 2)), rec(10, "serve.poll", *ms(2, 52)),
          rec(1, "serve.case", *ms(52, 452), key="c0"),
          rec(2, "serve.prefetch_wait", *ms(52, 152), parent=1, key="c0"),
          rec(3, "serve.dispatch", *ms(152, 152.1), parent=1, key="c0"),
          rec(4, "serve.dispatch", *ms(152.1, 352.1), parent=1, key="c0"),
          rec(5, "serve.fetch", *ms(352.1, 400), parent=1, key="c0"),
          rec(6, "serve.case", *ms(452, 800), key="c1"),
          rec(7, "serve.prefetch_wait", *ms(452, 452), parent=6, key="c1"),
          rec(8, "serve.dispatch", *ms(452, 752), parent=6, key="c1"),
          rec(9, "serve.fetch", *ms(752, 762), parent=6, key="c1"),
          rec(11, "serve.decode", *ms(160, 260), thread=PREFETCH, key="c1"),
          rec(12, "serve.case", *ms(900, 1200), key="late")]  # ends after the window


def read(name, r):
    return harness._metric_reader(name)(r)


def test_serving_readers():
    r = readings(SERVED, end=int(1000e6))
    assert read("prefetch_wait_ms.serve", r) == pytest.approx(50.0)  # (100 + 0) / 2 cases
    assert read("prefetch_wait_ms.spaced", r) == pytest.approx(50.0)
    assert read("poll_ms.serve", r) == pytest.approx(26.0)  # 52 ms of polling / 2 cases
    assert read("forward_dispatch_ms.serve", r) == pytest.approx(250.05)  # median of 200.1 and 300
    assert read("fetch_wait_ms.serve", r) == pytest.approx((47.9 + 10) / 2)


def test_train_reader():
    second = [rec(i + 10, s.name, s.start_ns + 1000, s.end_ns + 1000 + 30 * (s.name == "train.step"),
                  parent=s.parent and s.parent + 10, key=1) for i, s in enumerate(STEP)]
    r = readings(STEP + second, end=2000, steps=2)
    assert read("dispatch_ms.train", r) == pytest.approx(((10 + 80) + (10 + 110)) / 2 / 1e6)


def test_readers_leave_their_metric_out_without_program_spans(monkeypatch):
    names = [x["name"] for x in M["per_layer"] if x["source"] == "program_span"]
    assert len(names) == 6
    monkeypatch.setattr(program_spans, "_drain_program", lambda: None)  # a program without spans
    for name in names:
        r = harness.Readings(window_start_ns=0, window_end_ns=10)
        assert read(name, r) is None and r.program_spans is None
        assert read(name, readings([])) is None


def test_window_spans_drains_the_program_once():
    drain_spans()
    start_spans()
    t = threading.Thread(target=lambda: span("serve.decode", "x").__enter__().__exit__(None, None, None))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with span("serve.poll"):
        pass
    r = harness.Readings(window_start_ns=0, window_end_ns=2 ** 62)
    first = program_spans.window_spans(r)
    assert sorted(s.name for s in first) == ["serve.decode", "serve.poll"]
    assert program_spans.window_spans(r) == first and r.program_spans.dropped == 0
    assert drain_spans() == ([], 0)


def test_existing_readers_ignore_the_program_spans():
    trace = DeviceTrace(0, int(2e9), [(0, int(1e9), "conv3x3x3_kernel"), (int(1.2e9), int(1.5e9), "elementwise")])
    base = dict(window_start_ns=0, window_end_ns=int(2e9), trace=trace,
                counters={"steps": 4, "forwards": 80, "latency_s": [0.3, 0.4]},
                work={"flop": 1e14, "b1_bound_s": 0.5, "b2_bound_s": 0.2})
    names = [x["name"] for x in M["per_layer"] if x["source"] != "program_span"]
    plain = harness.Readings(**base)
    with_spans = harness.Readings(**base)
    with_spans.program_spans = Drained(SERVED, 0)
    assert [read(n, plain) for n in names] == [read(n, with_spans) for n in names]
