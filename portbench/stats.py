"""The benchmark's arithmetic over what a run recorded: percentiles, the
union of device intervals and its gaps, and the rule for issued operations."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# The CUDA runtime's launch and copy calls, by the prefix of their names in the
# profiler's raw records (frozen from profile_general.py:84, RUNTIME_CALLS): the
# operations the host issues to the card, each a launch or a copy; and a graph's
# launch, which the host issues as one operation however many it replays.
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch",
                 "cuGraphLaunch")


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by the nearest rank: the smallest
    value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of nothing")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The parts of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def is_issued(name: str) -> bool:
    return name.startswith(RUNTIME_CALLS)
