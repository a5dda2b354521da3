"""The device trace of a window and the benchmark's host spans, reduced to
what the per-layer metrics read.

The profiler records device activity only (kernels, copies, sets); the
benchmark keeps its own host spans (``Spans``) on the same clock the
profiler stamps its events with, the wall clock in nanoseconds."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Spans:
    """Host spans by name, each (start_ns, end_ns) on the wall clock; safe
    to record from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_name: Dict[str, List[Tuple[int, int]]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.by_name[name].append((t0, t1))

    def wrap(self, name: str, fn):
        """``fn`` with every call recorded as a span ``name``."""

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return wrapped

    def durations_s(self, name: str, start_ns: int, end_ns: int) -> List[float]:
        """Seconds of the spans ``name`` that ended inside [start_ns, end_ns]."""
        return [(b - a) / 1e9 for a, b in self.by_name.get(name, ()) if start_ns <= b <= end_ns]

    def labels(self, times_ns: List[int]) -> List[str]:
        """For each of the ascending ``times_ns``, the name of the latest
        started span open at that time, or 'none'."""
        spans = sorted((a, b, name) for name, ss in self.by_name.items() for a, b in ss)
        out, active, i = [], [], 0
        for t in times_ns:
            while i < len(spans) and spans[i][0] <= t:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] > t]
            out.append(max(active)[2] if active else "none")
        return out


@dataclass
class DeviceTrace:
    """Device operations inside a traced window [start_ns, end_ns]."""

    start_ns: int
    end_ns: int
    ops: List[Tuple[int, int, str]] = field(default_factory=list)  # (start, end, name)

    @classmethod
    def from_profiler(cls, prof, start_ns: int, end_ns: int) -> "DeviceTrace":
        """Kernels, copies and sets of a ``torch.profiler.profile`` run with
        CUDA activity (its annotations are left out)."""
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA" or e.is_user_annotation():
                continue
            a = e.start_ns()
            ops.append((a, a + e.duration_ns(), e.name()))
        ops.sort()
        return cls(start_ns, end_ns, ops)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the operations' intervals, clipped to the window."""
        out: List[List[int]] = []
        for a, b, _ in self.ops:
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds_by_name(self) -> Dict[str, float]:
        """Summed device seconds of each operation name."""
        out: Dict[str, float] = defaultdict(float)
        for a, b, name in self.ops:
            out[name] += (b - a) / 1e9
        return dict(out)

    def seconds_matching(self, *parts: str) -> Optional[float]:
        """Device seconds of the operations whose name holds any of
        ``parts``; None where no operation does."""
        hits = [(b - a) for a, b, name in self.ops if any(p in name for p in parts)]
        return sum(hits) / 1e9 if hits else None

    def total_s(self) -> float:
        return sum(b - a for a, b, _ in self.ops) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The window's intervals with no device operation running."""
        gaps, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        return gaps


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments' tail, for a report."""
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(trace: DeviceTrace, spans: Spans, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle time
    summed by the host span open at the start of each gap."""
    ops = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = defaultdict(float)
    gaps = trace.idle_gaps()
    for (a, b), label in zip(gaps, spans.labels([a for a, _ in gaps])):
        idle[label] += (b - a) / 1e9
    by_label = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short_name(n), s] for n, s in ops], "idle_gaps": [[n, s] for n, s in by_label]}
