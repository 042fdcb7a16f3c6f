"""One run of one cell: set-up, the measured window, the traced reduction and
the check against the reference.  `portbench/run.py` is the command line."""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch

from . import generator, stats, tracing
from .check import Snapshot, judge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# Top-level module names the run may not load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "coherence_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str):
    """(cell, its configuration's entry, its end-to-end metrics, its per-layer
    metrics) of the cell `name`."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mine = lambda m: name in m.get("workloads", [name])
    return cell, config, [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def load_config(entry: dict, root: str = ROOT) -> dict:
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def metric_reader(name: str):
    """portbench/metrics/<name>.py's read(traced)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set up, warm up, measure for `seconds`, then check.  Returns the
    result's fields: events, latencies, set-up seconds, the peak, the
    traced reduction and the check."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.scene import fastframe

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device.type == "cuda":
        kernels.load()
    traffic = generator.make(cell["traffic"], config, seed)
    kind = traffic.module
    scene = importlib.import_module(f"portbench.scenes.{config['scene']}")
    desc = scene.describe(config, seed)
    spans = tracing.Spans() if trace else None
    session = kind.open_session(desc, device, spans)
    events = traffic.events()
    for _ in range(traffic.n_warmup):
        kind.apply(session, next(events))
    _sync(device)
    snap_at = set(traffic.snapshots)
    snaps: List[Snapshot] = []

    b1_calls = []
    prof = None
    if trace:
        original = kernels.blur_blend_window

        def recorded(content, content_at, f_alpha, display, at, hb, wb, ry0, rx0, h, w, d_box, weights, total):
            b1_calls.append((int(content.shape[1]), tuple(at), hb, wb, ry0, rx0, h, w,
                             tuple(int(v) for v in d_box), len(weights) // 2))
            return original(content, content_at, f_alpha, display, at, hb, wb, ry0, rx0, h, w, d_box, weights, total)

        kernels.blur_blend_window = recorded
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU])
        prof.__enter__()
    host_ms, latency_ms, missed = [], [], []
    failed = copies = 0
    idx = traffic.n_warmup
    setup_s = time.perf_counter() - t_start
    wall_minus_perf = time.time_ns() - time.perf_counter_ns()
    start_ns = time.perf_counter_ns()
    deadline = start_ns + int(seconds * 1e9)
    while time.perf_counter_ns() < deadline:
        ev = next(events)
        misses = fastframe.scene_build_cache_stats()["misses"]
        t0 = time.perf_counter_ns()
        try:
            kind.apply(session, ev)
        except Exception as exc:  # the run reports the failure and stops: later events would build on it
            print(f"portbench: event {idx} {ev!r} failed: {exc!r}", file=sys.stderr)
            failed += 1
            break
        t1 = time.perf_counter_ns()
        _sync(device)
        t2 = time.perf_counter_ns()
        host_ms.append((t1 - t0) / 1e6)
        latency_ms.append((t2 - t0) / 1e6)
        missed.append(fastframe.scene_build_cache_stats()["misses"] > misses)
        if spans is not None:
            spans.records.append(("event", t0, t1))
            spans.records.append(("synchronize", t1, t2))
        if idx in snap_at:
            with spans.span("snapshot") if spans is not None else contextlib.nullcontext():
                snaps.append(session.snapshot(idx, kind.PIECES))
            copies += sum(isinstance(v, torch.Tensor) for v in snaps[-1])  # a clone is one launch or copy
        idx += 1
    end_ns = time.perf_counter_ns()
    traced = None
    if trace:
        _sync(device)
        prof.__exit__(None, None, None)
        kernels.blur_blend_window = original
    if not failed:
        snaps.append(session.snapshot(idx - 1, kind.PIECES))
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n = len(latency_ms)
    if trace:
        from .bounds import blur_bound

        bound_cache, b1_bound = {}, 0.0
        for call in b1_calls:
            if call not in bound_cache:
                cols, (oy, ox), hb, wb, ry0, rx0, h, w, d_box, radius = call
                bound_cache[call] = blur_bound(session.disp.f_alpha, cols, oy, ox, ry0, rx0, h, w, d_box, hb, wb,
                                               radius)["bound_ms"]
            b1_bound += bound_cache[call]
        traced = tracing.reduce(prof.profiler.kineto_results.events(), spans.records, start_ns, end_ns,
                                wall_minus_perf, n, host_ms, latency_ms, missed, copies, b1_bound, len(b1_calls))
        for note in traced.notes:
            print(f"portbench: {note}", file=sys.stderr)
    # The program's state goes before the reference runs: its caches too.
    events_replay = traffic.events()
    del session, events
    fastframe.scene_build_cache_clear()
    from coherence_tpu_torch.raster import tile_raster

    tile_raster.sweep_cache_clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = judge(desc, traffic, events_replay, snaps, device)
    print(f"portbench: the reference checked {checks['answers']} answers in {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    return {"n": n, "failed": failed, "window_s": (end_ns - start_ns) / 1e9, "latency_ms": latency_ms,
            "setup_s": setup_s, "peak": peak, "traced": traced, "checks": checks}


def end_to_end(res: dict) -> dict:
    lat = res["latency_ms"]
    return {
        "events_per_s": {"value": res["n"] / res["window_s"], "unit": "events/s"},
        "event_ms.p50": {"value": stats.percentile(lat, 50), "unit": "ms"},
        "event_ms.p95": {"value": stats.percentile(lat, 95), "unit": "ms"},
        "setup_s": {"value": res["setup_s"], "unit": "s"},
    }


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one portbench cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell, cfg_entry, e2e, layers = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    config = load_config(cfg_entry)
    res = run_cell(cell, config, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = res["checks"]
    correct = res["failed"] == 0 and checks["correct"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res["peak"]}
    out = {"correct": correct, "attempted": res["n"] + res["failed"], "failed": res["failed"]}
    if args.trace:
        tr = res["traced"]
        metrics = {}
        for m in layers:
            v = metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update({"busy_s": tr.busy_s, "window_s": tr.window_s, "power": power_limit()})
        out.update({"metrics": metrics, "device": device, "breakdown": tracing.breakdown(tr)})
    else:
        allm = end_to_end(res)
        out.update({"metrics": {m["name"]: allm[m["name"]] for m in e2e}, "device": device})
    out["checks"] = checks["numbers"]
    for name, v in checks["numbers"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0
