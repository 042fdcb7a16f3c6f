"""The benchmark's arithmetic: percentiles, rates, interval unions and idle
shares over synthetic events and intervals, a stall among them, and the rule
that counts issued operations."""

from types import SimpleNamespace

import pytest

from portbench import stats, tracing


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    # A stall: one event 100x the rest moves p95 only when it is past the 95th rank.
    lat = [1.0] * 99 + [100.0]
    assert stats.percentile(lat, 95) == 1.0 and stats.percentile(lat, 100) == 100.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_end_to_end_over_a_window_with_a_stall():
    from portbench import bench

    lat = [0.5] * 190 + [40.0] * 10  # ten events stall behind something
    got = bench.end_to_end({"n": 200, "window_s": 40.0, "latency_ms": lat, "setup_s": 9.5})
    assert got["events_per_s"] == {"value": 5.0, "unit": "events/s"}
    assert got["event_ms.p50"]["value"] == 0.5 and got["event_ms.p95"]["value"] == 0.5
    lat[180:190] = [40.0] * 10  # twenty: the 95th percentile is a stall now
    assert bench.end_to_end({"n": 200, "window_s": 40.0, "latency_ms": lat, "setup_s": 9.5})["event_ms.p95"]["value"] == 40.0
    assert got["setup_s"] == {"value": 9.5, "unit": "s"}


def test_union_and_gaps_with_a_stall():
    ivs = [(0.0, 1.0), (0.5, 2.0), (5.0, 6.0), (5.5, 5.7)]  # overlapping ops, then a 3 s stall
    assert stats.union_seconds(ivs) == pytest.approx(3.0)
    assert stats.gaps(ivs, 0.0, 10.0) == [(2.0, 5.0), (6.0, 10.0)]


@pytest.mark.parametrize("name,counted", [
    ("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True), ("cuLaunchKernel", True),
    ("cudaMemcpyAsync", True), ("cudaMemsetAsync", True), ("cudaGraphLaunch", True), ("cuGraphLaunch", True),
    ("cudaDeviceSynchronize", False), ("cudaGraphInstantiate", False),
    ("cudaStreamSynchronize", False), ("cudaEventRecord", False), ("aten::copy_", False)])
def test_issued_rule(name, counted):
    assert stats.is_issued(name) is counted


def _ev(name, dev, start_ns, dur_ns):
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev, start_ns=lambda: start_ns,
                           duration_ns=lambda: dur_ns)


def test_reduce_a_synthetic_window():
    wall = 10_000_000_000  # wall clock minus perf clock
    start, end = 1_000_000_000, 1_010_000_000  # a 10 ms window, perf clock
    w0 = start + wall
    raw = [
        _ev("cudaLaunchKernel", "DeviceType.CPU", w0 + 100_000, 5_000),
        _ev("cudaMemcpyAsync", "DeviceType.CPU", w0 + 200_000, 5_000),
        _ev("cudaLaunchKernel", "DeviceType.CPU", w0 + 20_000_000, 5_000),  # after the window
        _ev("blur_blend_kernel<true, false>", "DeviceType.CUDA", w0 + 1_000_000, 1_000_000),
        _ev("composite_dirty_kernel", "DeviceType.CUDA", w0 + 1_500_000, 1_000_000),  # overlaps
        _ev("shatter_kernel", "DeviceType.CUDA", w0 + 9_500_000, 1_000_000),  # clipped at the end
    ]
    spans = [("event", start, start + 3_000_000), ("step_animated", start, start + 2_000_000),
             ("synchronize", start + 3_000_000, start + 9_000_000)]
    tr = tracing.reduce(raw, spans, start, end, wall, n_events=2, host_ms=[2.0, 1.0], latency_ms=[9.0, 1.0],
                        missed=[], harness_copies=1, b1_bound_ms=0.25, b1_calls=1)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.002)  # 1.0-2.5 ms and 9.5-10 ms
    assert tr.issued == 1  # two in the window, less the benchmark's one copy
    assert tr.b1_device_ms == pytest.approx(1.0) and tr.b1_bound_ms == 0.25 and tr.notes == []
    # Each idle gap goes to the span its midpoint lies in: 0-1 ms to step_animated,
    # 2.5-9.5 ms (midpoint 6 ms) to the synchronize.
    assert dict(tr.idle_by_span) == pytest.approx({"step_animated": 0.001, "synchronize": 0.007})
    gap_mid_in_event = tracing.idle_by_span([(0.0021, 0.0029)], spans, start)
    assert gap_mid_in_event == [("event", pytest.approx(0.0008))]
    assert tracing.idle_by_span([(0.0095, 0.0099)], spans, start)[0][0] == "harness"
    b = tracing.breakdown(tr)
    assert b["device_ops"][0][0].startswith(("blur_blend", "composite_dirty"))
    assert len(b["device_ops"]) == 3 and b["idle_gaps"][0][0] == "synchronize"


@pytest.mark.parametrize("metric,expect", [("host_ms_per_event", 1.5), ("issued_per_event", 0.5),
                                           ("device_idle_share", 80.0), ("blur_blend_roofline", 25.0),
                                           ("zoom_miss_ms.p50", 9.0)])
def test_metric_readers(metric, expect):
    from portbench import bench

    tr = tracing.Traced(n_events=2, host_ms=[2.0, 1.0], latency_ms=[9.0, 1.0], missed=[True, False],
                        window_s=10.0, busy_s=2.0, device_ops=[], issued=1, b1_bound_ms=0.25, b1_device_ms=1.0,
                        idle_by_span=[], notes=[])
    assert bench.metric_reader(metric)(tr) == pytest.approx(expect)


def test_readers_find_nothing_to_read():
    from portbench import bench

    tr = tracing.Traced(n_events=2, host_ms=[2.0, 1.0], latency_ms=[9.0, 1.0], missed=[], window_s=10.0,
                        busy_s=2.0, device_ops=[], issued=8, b1_bound_ms=None, b1_device_ms=None, idle_by_span=[],
                        notes=[])
    assert bench.metric_reader("zoom_miss_ms.p50")(tr) is None
    assert bench.metric_reader("blur_blend_roofline")(tr) is None


def _b1_window(launches, rect=0, graph=False, first_at_ns=0):
    """A 10 ms window with `launches` B1 window launches of 1 us, 5 us apart
    from `first_at_ns` on, `rect` rect-mode launches, and the host's calls:
    a launch each, or one graph launch for all of them."""
    wall, start, end = 10_000_000_000, 1_000_000_000, 1_010_000_000
    w0 = start + wall
    raw = []
    for i in range(launches + rect):
        rect_mode = "true" if i >= launches else "false"
        name = f"void blur_blend_kernel<true, {rect_mode}>((anonymous namespace)::Params)"
        raw.append(_ev(name, "DeviceType.CUDA", w0 + first_at_ns + i * 5_000, 1_000))
        if not graph:
            raw.append(_ev("cudaLaunchKernel", "DeviceType.CPU", w0 + max(0, first_at_ns) + i * 5_000, 500))
    if graph:
        raw.append(_ev("cudaGraphLaunch", "DeviceType.CPU", w0, 5_000))
    return raw, start, end, wall


@pytest.mark.parametrize("calls,launches,rect,graph,kept", [
    (3, 3, 0, False, True),  # each window call one launch
    (3, 3, 2, False, True),  # rect-mode launches are not the window's
    (1, 3, 0, True, False),  # a graph replays launches its wrapper never saw
    (0, 3, 0, True, False),
    (0, 0, 1, False, False),  # no window at all
    (1000, 999, 0, False, True),  # the profiler lost one record: the bound over the 999 the trace holds
    (1000, 998, 0, False, False)])  # more lost than B1_LOST_SHARE allows
def test_b1_share_stands_only_on_matching_launches(calls, launches, rect, graph, kept):
    raw, start, end, wall = _b1_window(launches, rect, graph)
    tr = tracing.reduce(raw, [], start, end, wall, n_events=1, host_ms=[1.0], latency_ms=[1.0], missed=[False],
                        harness_copies=0, b1_bound_ms=0.0001 * calls, b1_calls=calls)
    from portbench import bench

    got = bench.metric_reader("blur_blend_roofline")(tr)
    if kept:
        assert got == pytest.approx(10.0)  # 0.1 us of bound over each launch's 1 us
        assert (tr.notes != []) == (launches != calls)
    else:
        assert got is None
        assert (tr.notes != []) == (launches != calls)
    assert tr.issued == (1 if graph else launches + rect)  # a graph's launch is one issued operation


@pytest.mark.parametrize("first_at_ns", [-3_000, 9_998_000], ids=["before_start", "past_end"])
def test_b1_launches_past_the_window_ends_still_count(first_at_ns):
    """A launch of the window's first or last event that the profiler's clock
    puts past the window's ends is one of B1's launches all the same."""
    raw, start, end, wall = _b1_window(3, first_at_ns=first_at_ns)
    tr = tracing.reduce(raw, [], start, end, wall, n_events=1, host_ms=[1.0], latency_ms=[1.0], missed=[False],
                        harness_copies=0, b1_bound_ms=0.0003, b1_calls=3)
    from portbench import bench

    assert bench.metric_reader("blur_blend_roofline")(tr) == pytest.approx(10.0)
    assert len(tr.notes) == 1 and "past the window's ends" in tr.notes[0]
