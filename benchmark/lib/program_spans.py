"""The program's own spans (``pcmseg_tpu_torch.utils.profiling``) as the
per-layer readers take them, and a traced window's device time and idle
gaps put down to them.

The program records its spans while a ``torch.profiler`` runs, as it does
through a traced run's window, on the clock that the profiler stamps
launches and device activity with (``time.time_ns()``). ``window_spans``
hands a reader the spans of the run's window; with a program that records
none it gives None, and the reader's metric is left out of the line.
``DeviceActivity`` keeps what ``DeviceTrace.from_profiler`` leaves out:
each operation's launch (the runtime or driver call of the same
correlation id, its start and its thread), and ``attribute`` puts each
operation down to the innermost span open where it was launched."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Hashable, Iterable, List, NamedTuple, Optional, Sequence, Tuple

NONE = "none"  # the label of time no program span covers


def _drain_program():
    try:
        from pcmseg_tpu_torch.utils.profiling import drain_spans
    except ImportError:  # a program that records no spans
        return None
    return drain_spans()


def window_spans(r) -> Optional[list]:
    """The program's spans that ended inside the window of readings ``r``
    (``SpanRecord``: name, start_ns, end_ns, thread, parent, key). They
    are drained from the program once and kept on ``r`` as
    ``program_spans`` (records, dropped); None where the program has none."""
    if getattr(r, "program_spans", None) is None:
        r.program_spans = _drain_program()
    if r.program_spans is None:
        return None
    return [s for s in r.program_spans[0] if r.window_start_ns <= s.end_ns <= r.window_end_ns]


def ms_by_key(spans: Iterable, *names: str) -> Dict[Hashable, float]:
    """Milliseconds of the spans named ``names``, summed by key."""
    out: Dict[Hashable, float] = defaultdict(float)
    for s in spans:
        if s.name in names:
            out[s.key] += (s.end_ns - s.start_ns) / 1e6
    return dict(out)


def keys_of(spans: Iterable, name: str) -> List[Hashable]:
    """The keys of the spans named ``name``, in the order they ended."""
    return [s.key for s in spans if s.name == name]


# ---- device time by program span --------------------------------------------------


class Op(NamedTuple):
    """A kernel, copy or set on the card."""

    start_ns: int
    end_ns: int
    name: str
    correlation: int
    stream: int


@dataclass
class DeviceActivity:
    """The device operations of a traced window and, by correlation id, the
    host calls that launched them: (start_ns, thread), the thread as CUPTI
    gives it (the low 32 bits of ``threading.get_ident()``, signed); and
    the host's calls that can wait for the card (synchronizes and copies:
    a copy to pageable memory blocks inside ``cudaMemcpyAsync``; start_ns,
    end_ns, name, thread)."""

    ops: List[Op] = field(default_factory=list)
    launches: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    waits: List[Tuple[int, int, str, int]] = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "DeviceActivity":
        """From a profile's ``kineto_results.events()``: the CUDA events but
        annotations, for each of their correlation ids the earliest host
        event of that id (a launch holds the module loading it triggers),
        and the host's synchronize and copy calls."""
        ops, host, waits = [], {}, []
        for e in events:
            if e.is_user_annotation():
                continue
            a, c = e.start_ns(), e.correlation_id()
            if e.device_type().name == "CUDA":
                ops.append(Op(a, a + e.duration_ns(), e.name(), c, e.device_resource_id()))
                continue
            if c and (c not in host or a < host[c][0]):
                host[c] = (a, e.device_resource_id())
            if "Synchronize" in e.name() or "Memcpy" in e.name():
                waits.append((a, a + e.duration_ns(), e.name(), e.device_resource_id()))
        ops.sort()
        waits.sort()
        return cls(ops, {op.correlation: host[op.correlation] for op in ops if op.correlation in host}, waits)


def _thread32(thread: int) -> int:
    return thread & 0xFFFFFFFF


class SpanIndex:
    """Innermost open span at a time, on one thread or on any: spans on one
    thread nest, so the innermost open at t is the last one started by t,
    or the nearest of its ancestors still open."""

    def __init__(self, spans: Sequence):
        self.by_id = {s.id: s for s in spans}
        self.threads: Dict[int, Tuple[List[int], list]] = {}
        per: Dict[int, list] = defaultdict(list)
        for s in spans:
            per[_thread32(s.thread)].append(s)
        for t, ss in per.items():
            ss.sort(key=lambda s: (s.start_ns, -s.end_ns))
            self.threads[t] = ([s.start_ns for s in ss], ss)

    def on_thread(self, thread: int, t: int):
        starts, ss = self.threads.get(_thread32(thread), ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        s = ss[i]
        while s is not None and s.end_ns <= t:
            s = self.by_id.get(s.parent)
        return s

    def anywhere(self, t: int):
        """The innermost span open at ``t`` on each thread, the latest started of them."""
        open_ = [s for s in (self.on_thread(th, t) for th in self.threads) if s is not None]
        return max(open_, key=lambda s: s.start_ns) if open_ else None


@dataclass
class Attribution:
    """Each operation's span (None: none open at its launch), and how its
    span was found: 'thread' (open on the launching thread), 'time' (open
    on another thread at the launch time: the autograd engine launches the
    backward from its own thread while the caller waits inside
    ``train.backward``), 'stream' (no launch recorded: the span of the
    previous operation on its stream) or 'none'."""

    ops: List[Op]
    spans: list
    how: List[str]

    def _inside(self, start_ns: int, end_ns: int):
        """(operation, span name, rule, seconds inside [start_ns, end_ns])."""
        for op, s, how in zip(self.ops, self.spans, self.how):
            a, b = max(op.start_ns, start_ns), min(op.end_ns, end_ns)
            if b > a:
                yield op, s.name if s is not None else NONE, how, (b - a) / 1e9

    def device_s(self, start_ns: int, end_ns: int) -> Dict[str, float]:
        """Device seconds inside [start_ns, end_ns] by span name."""
        out: Dict[str, float] = defaultdict(float)
        for _, name, _, sec in self._inside(start_ns, end_ns):
            out[name] += sec
        return dict(out)

    def device_s_by_rule(self, start_ns: int, end_ns: int) -> Dict[str, float]:
        """Device seconds inside [start_ns, end_ns] by how their span was found."""
        out: Dict[str, float] = defaultdict(float)
        for _, _, how, sec in self._inside(start_ns, end_ns):
            out[how] += sec
        return dict(out)

    def top_ops(self, start_ns: int, end_ns: int, top: int = 5) -> Dict[str, List[Tuple[str, float]]]:
        """The operations that took the most device seconds, by span name."""
        out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        for op, name, _, sec in self._inside(start_ns, end_ns):
            out[name][op.name] += sec
        return {k: sorted(v.items(), key=lambda kv: -kv[1])[:top] for k, v in out.items()}


def attribute(activity: DeviceActivity, spans: Sequence) -> Attribution:
    """Each operation of ``activity`` put down to the innermost program span
    open at its launch, on the launching thread where one is open there,
    else at that time on any thread; an operation without a launch takes
    the span of the previous operation on its stream that had one."""
    index = SpanIndex(spans)
    out_spans, how = [], []
    last_on_stream: Dict[int, object] = {}
    for op in activity.ops:
        launch = activity.launches.get(op.correlation)
        if launch is None:
            s = last_on_stream.get(op.stream)
            out_spans.append(s)
            how.append("stream" if s is not None else NONE)
            continue
        t, thread = launch
        s = index.on_thread(thread, t)
        rule = "thread"
        if s is None:
            s, rule = index.anywhere(t), "time"
        out_spans.append(s)
        how.append(rule if s is not None else NONE)
        last_on_stream[op.stream] = s
    return Attribution(activity.ops, out_spans, how)


def wait_spans(waits: Sequence[Tuple[int, int, str, int]], spans: Sequence) -> List[str]:
    """For each of the host's calls that can wait for the card, the
    innermost program span open on the calling thread when it began (else
    on any thread)."""
    index = SpanIndex(spans)
    out = []
    for a, _, _, thread in waits:
        s = index.on_thread(thread, a)
        s = s if s is not None else index.anywhere(a)
        out.append(s.name if s is not None else NONE)
    return out


def idle_by_span(gaps: Sequence[Tuple[int, int]], spans: Sequence, thread: Optional[int] = None) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap cut where a span
    of ``thread`` (the one whose phases pace the card) begins or ends, and
    each piece put down to the innermost span open on that thread, else to
    the latest started open on any."""
    index = SpanIndex(spans)
    mine = [] if thread is None else [s for s in spans if _thread32(s.thread) == _thread32(thread)]
    cuts = sorted({t for s in mine for t in (s.start_ns, s.end_ns)})
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        points = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for p, q in zip(points, points[1:]):
            s = index.on_thread(thread, p) if thread is not None else None
            s = s if s is not None else index.anywhere(p)
            out[s.name if s is not None else NONE] += (q - p) / 1e9
    return dict(out)
