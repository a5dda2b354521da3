"""Profiling hooks on ``torch.profiler``, the port of ``pcmseg_tpu/utils/profiling.py``,
and the program's spans.

``trace`` wraps a region in a profiler trace written to a directory as a
Chrome / TensorBoard trace (``*.pt.trace.json``: open it in
``chrome://tracing``, Perfetto, or TensorBoard's profiler plugin);
``StepTraceController`` traces a window of training steps or served cases.
Host (CPU) activity is always recorded, the card's kernels and copies too
when the caller's device is a CUDA device. Each takes the caller's device;
none reads a global default.

``span(name, key)`` marks a phase of the program at a layer boundary. A
span is off by default, and then costs one flag test and returns one
shared no-op context: no clock read, no allocation, no lock, no
``record_function``. Spans are live between ``start_spans()`` and
``drain_spans()``, and while a ``torch.profiler`` runs in the process (a
``trace`` or ``StepTraceController`` window, or a profiler of the
caller's own). A live span records its name, start and end on
``time.time_ns()`` (the clock that ``torch.profiler`` stamps host events,
launches and device activity with), its thread, its parent (the innermost
span open on the same thread) and its key (the step number in training,
the case id in serving; a span given none takes its parent's) into a
buffer of ``SPAN_CAPACITY`` records; a span that finds it full is counted
as dropped. While a profiler runs each live span also opens a
``record_function`` of its name, so a trace shows the phases as user
annotations. The spans:

    train.gather            the cached batch's gather, crop and augmentation (data/device_cache.py)
    train.step              one optimizer step (train/steps.py, key: the step number)
      train.forward         a microbatch's forward and loss
      train.backward        a microbatch's backward; the gradient all-reduce of a job of several ranks
      train.optimizer       the mean over microbatches, the norm, clip and Adam, the EMA
    serve.poll              the inbox's listing, the sleep between polls (infer/serve.py)
    serve.case              one served case (key: its id)
      serve.prefetch_wait   the wait for the case's decode on the prefetch thread
      serve.dispatch        the ingest, the ensemble x TTA forwards and the threshold issued to the card
      serve.fetch           the mask's copy to the host: the host waiting for the card
      serve.postprocess     the mask's postprocessing
      serve.write           the mask's file
    serve.decode            a case's host decode and normalize, on the prefetch thread (key: its id)

Usage:
    from pcmseg_tpu_torch.utils.profiling import drain_spans, span, start_spans, trace
    with trace("/tmp/pcmseg_trace", device):
        for step in range(10):
            with span("step", step):
                metrics = train_step(state, batch)
    start_spans()
    ...
    records, dropped = drain_spans()
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Hashable, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, record_function, tensorboard_trace_handler

SPAN_CAPACITY = 1 << 16  # records kept between drains: ~2,000 spans in a 30 s window of training or serving


def _activities(device: torch.device) -> List[ProfilerActivity]:
    device = torch.device(device)
    if device.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _sync(device: torch.device) -> None:
    """Wait for the card, so a trace starts and ends with no work in flight."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start(log_dir: str, device) -> torch.profiler.profile:
    _sync(device)
    prof = torch.profiler.profile(
        activities=_activities(device), on_trace_ready=tensorboard_trace_handler(log_dir)
    )
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, device) -> None:
    _sync(device)
    prof.stop()  # runs on_trace_ready: the trace file is written here


@contextlib.contextmanager
def trace(log_dir: Optional[str], device) -> Iterator[None]:
    """Profiler trace of the enclosed region on ``device`` into ``log_dir``
    (a no-op when ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    prof = _start(log_dir, device)
    try:
        yield
    finally:
        _stop(prof, device)


class StepTraceController:
    """Traces a fixed window of steps on ``device`` into a profiler trace.

    Wired to the trainer through ``config.profile_dir`` / ``--profile``: the
    trace starts at ``start_step`` (default 1, skipping the first, cold
    step) and stops after ``n_steps`` steps, or at ``close()`` if the epoch
    is shorter. One-shot: only the first window is captured. The card is
    synchronised where the window opens and where it closes, so the window
    holds exactly its steps' kernels.
    """

    def __init__(self, log_dir: Optional[str], device, start_step: int = 1, n_steps: int = 5):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.start_step = start_step
        self.n_steps = max(1, n_steps)
        self._prof: Optional[torch.profiler.profile] = None
        self._done = not log_dir
        self._seen = 0  # GLOBAL steps observed, across epochs

    def on_step(self, step_idx: int) -> None:
        """Call at the TOP of each step. The trigger counts steps globally
        (across epochs), so the window is still captured when epochs are
        shorter than ``start_step``; ``step_idx`` is accepted for the call
        site's readability and not used as a clock."""
        if self._done:
            return
        if self._prof is None and self._seen == self.start_step:
            self._prof = _start(self.log_dir, self.device)
        elif self._prof is not None and self._seen >= self.start_step + self.n_steps:
            self.close()
        self._seen += 1

    def close(self) -> None:
        """Stop the trace if it is running. Called at every epoch end; if the
        trace never started (an epoch shorter than ``start_step``), it stays
        armed, so a later epoch's steps are still captured."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self._done = True
            _stop(prof, self.device)


class SpanRecord(NamedTuple):
    """One live span. ``thread`` is ``threading.get_ident()``, whose low 32
    bits are the thread id that CUPTI gives a launch; ``parent`` is the
    ``id`` of the innermost span open on the same thread when it began."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    key: Optional[Hashable]


class Drained(NamedTuple):
    records: List[SpanRecord]  # in the order the spans ended
    dropped: int  # spans that found the buffer full


class _Recorder:
    """The process's span buffer and each thread's stack of open spans."""

    def __init__(self, capacity: int):
        self.on = False
        self.capacity = capacity
        self.lock = threading.Lock()
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(record)
            else:
                self.dropped += 1

    def drain(self) -> Drained:
        with self.lock:
            out = Drained(self.records, self.dropped)
            self.records, self.dropped = [], 0
        return out


_RECORDER = _Recorder(SPAN_CAPACITY)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "key", "id", "parent", "start_ns", "annotation", "stack")

    def __init__(self, name: str, key: Optional[Hashable]):
        self.name, self.key = name, key

    def __enter__(self) -> "_Span":
        self.stack = _RECORDER.open_spans()
        outer = self.stack[-1] if self.stack else None
        self.parent = outer.id if outer is not None else None
        if self.key is None and outer is not None:
            self.key = outer.key
        self.id = next(_RECORDER.ids)
        self.stack.append(self)
        # the span's interval holds its annotation's, so the two nest in a trace
        self.start_ns = time.time_ns()
        self.annotation = record_function(self.name) if autograd_profiler._is_profiler_enabled else None
        if self.annotation is not None:
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end_ns = time.time_ns()
        self.stack.pop()
        _RECORDER.add(SpanRecord(self.id, self.name, self.start_ns, end_ns, threading.get_ident(), self.parent,
                                 self.key))


def span(name: str, key: Optional[Hashable] = None):
    """A context marking phase ``name`` of the program (module docstring)."""
    if _RECORDER.on or autograd_profiler._is_profiler_enabled:
        return _Span(name, key)
    return _OFF


def start_spans() -> None:
    """Empty the span buffer and record every span until ``drain_spans()``."""
    _RECORDER.drain()
    _RECORDER.on = True


def drain_spans() -> Drained:
    """Stop the recording ``start_spans()`` began, and hand back the spans
    recorded since the buffer was last emptied (a profiler's window
    included) with the count dropped, emptying the buffer."""
    _RECORDER.on = False
    return _RECORDER.drain()
