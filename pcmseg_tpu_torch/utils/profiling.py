"""Profiling hooks on ``torch.profiler``, the port of ``pcmseg_tpu/utils/profiling.py``.

``trace`` wraps a region in a profiler trace written to a directory as a
Chrome / TensorBoard trace (``*.pt.trace.json``: open it in
``chrome://tracing``, Perfetto, or TensorBoard's profiler plugin);
``annotate`` marks a named host span inside it; ``StepTraceController``
traces a window of training steps or served cases. Host (CPU) activity is
always recorded, the card's kernels and copies too when the caller's device
is a CUDA device. Each takes the caller's device; none reads a global
default.

Usage:
    from pcmseg_tpu_torch.utils.profiling import trace, annotate
    with trace("/tmp/pcmseg_trace", device):
        for step in range(10):
            with annotate(f"step{step}"):
                metrics = train_step(state, batch)
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Union

import torch
from torch.profiler import ProfilerActivity, record_function, tensorboard_trace_handler


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


def annotate(name: str):
    """Named host-side span, visible in the profiler timeline."""
    return record_function(name)


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


@contextlib.contextmanager
def device_memory_report(devices: Union[torch.device, str, Sequence]) -> Iterator[None]:
    """Print each CUDA device's memory use after the enclosed region (best
    effort; prints nothing for a CPU device)."""
    try:
        yield
    finally:
        if isinstance(devices, (torch.device, str)):
            devices = [devices]
        for d in map(torch.device, devices):
            if d.type != "cuda":
                continue
            stats = torch.cuda.memory_stats(d)
            used = stats.get("allocated_bytes.all.current", 0) / 2**30
            peak = stats.get("allocated_bytes.all.peak", 0) / 2**30
            total = torch.cuda.get_device_properties(d).total_memory / 2**30
            print(f"{d}: {used:.2f} GiB in use, peak {peak:.2f} GiB / {total:.2f} GiB")
