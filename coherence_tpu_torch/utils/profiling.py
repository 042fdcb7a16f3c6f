"""Named counters, wall-clock timers and a device trace: the port's copy of
``coherence_tpu.utils.profiling``, whose ``trace`` wraps the JAX profiler;
here it records a ``torch.profiler`` trace (CPU and, where a card is
present, CUDA activities) into the same ``log_dir``."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

counters: Dict[str, int] = defaultdict(int)
timers: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [calls, secs]


def counter(name: str, inc: int = 1) -> None:
    counters[name] += inc


@contextlib.contextmanager
def time_block(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = timers[name]
        rec[0] += 1
        rec[1] += time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a device-level profile viewable in TensorBoard/Perfetto: one
    Chrome trace file written into `log_dir` (by default ``coherence_trace``
    in the temporary directory) when the block ends."""
    import os
    import tempfile

    import torch

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "coherence_trace")

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield


def report() -> str:
    lines = ["counters:"]
    for k in sorted(counters):
        lines.append(f"  {k}: {counters[k]}")
    lines.append("timers:")
    for k in sorted(timers):
        calls, secs = timers[k]
        avg = secs / calls * 1000 if calls else 0.0
        lines.append(f"  {k}: {calls} calls, {secs:.3f}s total, {avg:.2f}ms avg")
    return "\n".join(lines)


def reset() -> None:
    counters.clear()
    timers.clear()
