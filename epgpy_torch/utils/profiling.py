"""Profiling helpers (the reference has no tracing subsystem).

Counterpart of ``epgpy_tpu/utils/profiling.py``: thin wrappers over
``torch.profiler`` that write a Chrome trace (``chrome://tracing``,
Perfetto) of the host calls and, on the card, of the CUDA kernels they
launch.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace("/tmp/tb"): simulate(...)``.

    Records CPU activity, and CUDA activity where a card is present, and
    writes ``logdir/trace_<pid>_<ns>.json`` (a Chrome trace) when the block
    ends.  The profiler object is yielded (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside a trace (context manager)."""
    return torch.profiler.record_function(name)
