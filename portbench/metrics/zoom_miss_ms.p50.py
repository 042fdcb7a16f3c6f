"""zoom_miss_ms.p50: the median latency of the events that the scene-build
cache counted as a miss (fastframe.scene_build_cache_stats()); nothing in a
window with none."""

import statistics


def read(traced):
    ms = [lat for lat, miss in zip(traced.latency_ms, traced.missed) if miss]
    return statistics.median(ms) if ms else None
