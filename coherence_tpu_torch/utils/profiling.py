"""Named counters and wall-clock timers: the port's copy of the host half
of ``coherence_tpu.utils.profiling`` (its profiler hook wraps the JAX
profiler and is not kept; ``torch.profiler`` is used directly where a
device trace is wanted)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

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
