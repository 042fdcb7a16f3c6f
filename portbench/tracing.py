"""What a traced run records, and its reduction to what the per-layer metric
readers (portbench/metrics/) and the breakdown read.

Spans are the benchmark's own, around each call into a layer of the port, in
`time.perf_counter_ns`.  The device's operations and the CUDA runtime's calls
come from torch.profiler's raw records, whose clock is the wall clock: one
reading of both clocks at the window's start puts them on one axis."""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

from . import stats

# B1's window mode as the trace names its launches: blur_blend_kernel<kPacked, kRect>
# with kRect false (kernels/csrc/blur_blend.cu); the rect mode is a full refresh's.
B1_WINDOW = re.compile(r"blur_blend_kernel<\w+, false>")
# The share of B1's window calls whose device record a trace may lack (the
# profiler can lose a record; its runtime records still hold the launch) with
# the share still read, over the launches the trace holds.  More launches than
# calls (a replayed graph the wrapper never saw) always leaves it out.
B1_LOST_SHARE = 0.001


class Spans:
    """Spans as (name, start_ns, end_ns), kept in memory."""

    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter_ns()))


class Traced(NamedTuple):
    """One traced window, reduced.  Times in seconds and milliseconds; the
    device's operations as (name, start_s, end_s) from the window's start."""

    n_events: int
    host_ms: List[float]  # each event's call, start to return
    latency_ms: List[float]  # each event, start to the end of its synchronize
    missed: List[bool]  # each event: did the scene-build cache count a miss (empty if not read)
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]]
    issued: int  # the CUDA runtime's launch and copy calls, less the benchmark's own copies
    b1_bound_ms: Optional[float]  # blur_blend's bound summed over its windows, None where it ran none
    b1_device_ms: Optional[float]  # blur_blend's device time from the trace, None with its bound
    idle_by_span: List[Tuple[str, float]]  # device idle seconds by the span the host was in
    notes: List[str]  # why a reading is left out


def reduce(raw_events, spans: List[Tuple[str, int, int]], start_ns: int, end_ns: int, wall_minus_perf_ns: int,
           n_events: int, host_ms, latency_ms, missed, harness_copies: int, b1_bound_ms: float,
           b1_calls: int) -> Traced:
    """`raw_events`: the profiler's raw records; `spans` and the window's
    ends in perf_counter_ns.  `b1_bound_ms` is B1's bound summed over the
    `b1_calls` window calls that its wrapper saw: it stands only where the
    trace holds as many window launches of B1, or at most B1_LOST_SHARE
    fewer, since a launch that bypasses the wrapper (a replayed graph) adds
    time and no bound.  B1's launches are counted over the whole trace, which
    holds none but the window's events' (it starts after the warm-up and
    stops before the last snapshot), so that a skew between the profiler's
    clock and the host's at the window's ends drops none."""
    w0, w1 = start_ns + wall_minus_perf_ns, end_ns + wall_minus_perf_ns
    ops, issued, b1 = [], 0, []
    for e in raw_events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if B1_WINDOW.search(name):
                b1.append((s, t))
            s, t = max(s, w0), min(t, w1)
            if t > s:
                ops.append((name, (s - w0) / 1e9, (t - w0) / 1e9))
        elif stats.is_issued(name) and w0 <= e.start_ns() <= w1:
            issued += 1
    intervals = [(s, t) for _, s, t in ops]
    window_s = (end_ns - start_ns) / 1e9
    notes = []
    past = sum(1 for s, t in b1 if s < w0 or t > w1)
    if past:
        notes.append(f"{past} of B1's {len(b1)} window launches lie past the window's ends on the profiler's clock")
    lost = b1_calls - len(b1)
    b1_ok = bool(b1) and 0 <= lost <= B1_LOST_SHARE * b1_calls
    if lost and not b1_ok:
        notes.append(f"blur_blend_roofline left out: the trace holds {len(b1)} window launches of B1 "
                     f"and its wrapper saw {b1_calls} calls")
    elif lost:
        notes.append(f"the trace lacks {lost} of B1's {b1_calls} window launches: its bound is taken over the "
                     f"{len(b1)} it holds")
    return Traced(n_events, list(host_ms), list(latency_ms), list(missed), window_s,
                  stats.union_seconds(intervals), ops, issued - harness_copies,
                  b1_bound_ms * len(b1) / b1_calls if b1_ok else None,
                  sum(t - s for s, t in b1) / 1e6 if b1_ok else None,
                  idle_by_span(stats.gaps(intervals, 0.0, window_s), spans, start_ns), notes)


_OUTER = "event"  # the harness's span around a whole event's calls


def idle_by_span(gaps, spans, start_ns: int) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost span the host was in at each
    gap's midpoint: a port layer's call, the synchronize, the benchmark's own
    work; "event" for the host between calls inside an event, "harness"
    outside every span."""
    leaves = sorted((s, t, n) for n, s, t in spans if n != _OUTER)
    outer = sorted((s, t) for n, s, t in spans if n == _OUTER)
    leaf_starts = [s for s, _, _ in leaves]
    outer_starts = [s for s, _ in outer]
    out = defaultdict(float)
    for a, b in gaps:
        mid = start_ns + int((a + b) / 2 * 1e9)
        name = "harness"
        i = bisect.bisect_right(leaf_starts, mid) - 1
        if i >= 0 and leaves[i][1] >= mid:
            name = leaves[i][2]
        else:
            j = bisect.bisect_right(outer_starts, mid) - 1
            if j >= 0 and outer[j][1] >= mid:
                name = _OUTER
        out[name] += b - a
    return sorted(out.items(), key=lambda kv: -kv[1])


def breakdown(tr: Traced) -> dict:
    """The device operations that took most time, by name, and the idle time
    by what the host was doing: at most 10 of each, in seconds."""
    by_op = defaultdict(float)
    for n, s, t in tr.device_ops:
        by_op[n] += t - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in top], "idle_gaps": [[n, v] for n, v in tr.idle_by_span[:10]]}
