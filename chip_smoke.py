#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Three paths run, each with the launch counters zeroed just before it and
read just after:

  * the lion (bench.py) at 1920x1080: the lion's 132 paths rasterized into
    a 1024-slot tile atlas, a translucent crimson blob (r=60) reserved for
    in-place moves, a radius-5 Gaussian blur filter over the band F_BOX,
    then 400 animated frames dragging the blob by (7, 3) and back by
    (-7, -3) every 200 frames;
  * the interactive 4K scene (benchmarks/run.py config 5) at 3840x2160:
    1000 circles and rectangles and 6 Gaussian brush strokes in a
    4096-slot atlas, a crimson blob (r=70) under a radius-4 blur band; 200
    filtered frames, 200 plain frames, full-frame renders through
    composite_full and composite_runs, 4 zoom steps (2x and back about
    the frame centre, through the scene-build cache), then a prefetch of
    both zoom directions and a 0.5x step;
  * the dense layer stack (benchmarks/run.py config 2): 100 rectangles at
    1088x1920, composited over white by composite_layers.

Phases, one JSON line each:

  1. device: the card's name, and nvidia-smi's name and power limit;
  2. build: the CUDA kernels compiled from the checkout's sources;
  3. kernels: composite_full and composite_dirty against their plain
     PyTorch versions on the card, on the lion's shapes, bit for bit, with
     both times (CUDA events, cold L2);
  4. main_path: the lion, built and run 400 frames; per-frame times; the
     display after 20 frames held bit for bit against the same 20 frames
     run on the CPU through the plain versions; one full-frame render held
     against the dirty-path content;
  5. interactive_4k: config 5 on the card; its atlas, piece lists and
     display after 3 filtered frames held bit for bit against the same run
     on the CPU; frame times, build and zoom seconds, cache hits; the full
     renders held against the dirty-path content;
  6. kernels_4k: composite_runs against composite_runs_torch and against
     composite_full on config 5's full-frame lists, bit for bit, timed;
  7. hsr_layers: config 2's stack through composite_layers, then the
     kernel against composite_layers_torch over noise and over white, bit
     for bit, timed.

Then the kernels line and, last, {"ok": true, "device": {...}}.  Any
mismatch or exception ends the run with a nonzero exit code.
"""

import json
import statistics
import subprocess
import sys
import time

W, H = 1920, 1080
BLUR_RADIUS = 5
F_BOX = (40, 320, 1680, 1060)
ATLAS_CAP = 1024
N_FRAMES = 400
N_CHECK = 20
N_TIMED = 25

# The interactive 4K scene (benchmarks/run.py config 5).
W4, H4 = 3840, 2160
BLUR4 = 4
ATLAS_CAP4 = 4096
N_FRAMES4 = 200
N_ZOOMS = 4
# The dense layer stack (benchmarks/run.py config 2).
HSR_K, HSR_H, HSR_W = 100, 1088, 1920

CSRC = "coherence_tpu_torch/kernels/csrc/"
SOURCE = CSRC + "tile_composite.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def build_scene(device):
    """The bench.py scene on `device`, through the port's entry points.
    Returns (view, display, blob_key)."""
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import examples, fastframe

    objs, blob, f_geom = examples.bench_scene(W, H, blob_radius=60, blob_at=(120, 400), f_box=F_BOX)
    view = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=device)
    view.set_scene(objs)
    view.sprites[blob.idset] = fastframe.tiled_sprite_of_object(blob, view.pw, view.ph, device)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    f_alpha = fastframe.alpha_plane_of_object(f_geom, W, H, device)
    disp = fastframe.FilteredDisplay(view, f_alpha, convolve.mkgaussian(BLUR_RADIUS))
    disp.full_refresh()
    return view, disp, blob.idset


def delta(k: int):
    return (7, 3) if (k // 200) % 2 == 0 else (-7, -3)


def build_interactive(device):
    """Config 5 on `device`, through the port's entry points, as run.py
    builds it.  Returns (view, display, blob_key, objects)."""
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import examples, fastframe

    objs, blob, f_geom = examples.interactive_4k_scene(W4, H4)
    view = fastframe.DeviceView(W4, H4, atlas_cap=ATLAS_CAP4, device=device)
    view.set_scene(objs)
    view.sprites[blob.idset] = fastframe.tiled_sprite_of_object(blob, view.pw, view.ph, device)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    disp = fastframe.FilteredDisplay(view, fastframe.alpha_plane_of_object(f_geom, W4, H4, device),
                                     convolve.mkgaussian(BLUR4))
    disp.full_refresh()
    return view, disp, blob.idset, objs


def delta4(k: int):
    return (9, 4) if (k // 100) % 2 == 0 else (-9, -4)


def filtered_frame(view, disp, key, k: int) -> None:
    """run.py config 5's filtered frame: move the blob, refresh the display."""
    from coherence_tpu_torch.raster import region

    prev = view.sprites[key].box
    view.translate_object(key, *delta4(k))
    disp.step(region.box_union(prev, view.sprites[key].box))


def plain_frame(view, key, k: int) -> None:
    view.translate_object(key, *delta4(k))
    view.render()


def zoomed(objs, f: float):
    """The scene scaled by `f` about the 4K frame's centre, as a zoom step
    makes it."""
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    tmat = fastframe.zoom_transform(W4 / 2.0, H4 / 2.0, f)
    return [R.transform_renderobject_many(tmat, o) for o in objs]


def timed_frames(torch, fn, n: int):
    """(per-frame CUDA-event ms, host seconds) of fn(k) for k < n."""
    events = []
    t0 = time.perf_counter()
    for k in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(k)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in events], time.perf_counter() - t0


def frame_stats(ms):
    steady = sorted(ms[1:])
    return {"first_ms": ms[0], "median_ms": statistics.median(steady),
            "p95_ms": steady[int(0.95 * (len(steady) - 1))]}


def scene_state(view):
    return view.ts.atlas().cpu().clone(), [list(view.ts.pieces[k]) for k in view.order]


def event_ms(torch, fn, scrub, reps: int = N_TIMED):
    """Median CUDA-event time (ms) of `reps` calls of fn, each after
    `scrub` (a buffer larger than the 50 MB L2) is overwritten, so every
    call starts with a cold L2 as a once-per-frame caller would."""
    times = []
    for _ in range(reps):
        scrub.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def with_passthrough(coords, spans, n_real: int, tile):
    """The dirty slot arrays with a passthrough slot (span -1) for `tile`
    put first, re-padded by repeating the last real slot."""
    import numpy as np

    n = n_real + 1
    n_slots = 8
    while n_slots < n:
        n_slots *= 2
    c = np.zeros(2 * n_slots, np.int32)
    s = np.zeros(2 * n_slots, np.int32)
    c[0:2] = tile
    s[0:2] = -1
    c[2 : 2 * n] = coords[: 2 * n_real]
    s[2 : 2 * n] = spans[: 2 * n_real]
    c[2 * n :: 2], c[2 * n + 1 :: 2] = c[2 * n - 2], c[2 * n - 1]
    s[2 * n :: 2], s[2 * n + 1 :: 2] = s[2 * n - 2], s[2 * n - 1]
    return c, s, n_slots


def zero_counts(torch, kernels) -> None:
    for k in kernels.launches:
        kernels.launches[k] = 0
    torch.cuda.synchronize()


def lion_kernels(torch, dev, scrub):
    """Phase 3: composite_full and composite_dirty against their plain
    versions on the lion's lists.  Returns {kernel: (max_abs_err, ms,
    plain_ms)}."""
    from coherence_tpu_torch.raster import tiled_scene as T

    view, disp, key = build_scene(dev)
    ts = view.ts
    starts, idxs = ts.build_lists(view.order)
    full_k = T.composite_full(starts, idxs, view.background, ts.atlas(), ts.nty, ts.ntx)
    full_p = T.composite_full_torch(starts, idxs, view.background, ts.atlas(), ts.nty, ts.ntx)
    torch.cuda.synchronize()
    require(torch.equal(full_k, full_p), "composite_full differs from composite_full_torch")
    full_err = max_abs_err(full_k, full_p)
    full_ms = event_ms(torch, lambda: T.composite_full(starts, idxs, view.background, ts.atlas(), ts.nty, ts.ntx), scrub)
    full_plain_ms = event_ms(
        torch, lambda: T.composite_full_torch(starts, idxs, view.background, ts.atlas(), ts.nty, ts.ntx), scrub
    )
    n_listed = int(starts[-1])

    moved, (oys, oxs, base), entries, win, dirty = disp.stage_animated(key, *delta(0))
    require(dirty is not None, "the first animated step has no blur window")
    coords, spans, didx, n_slots = dirty
    n_real = len({(int(coords[2 * j]), int(coords[2 * j + 1])) for j in range(n_slots)})
    dirty_tiles = {int(coords[2 * j]) * ts.ntx + int(coords[2 * j + 1]) for j in range(n_real)}
    spare = next(t for t in range(ts.nty * ts.ntx) if t not in dirty_tiles)
    coords, spans, n_slots = with_passthrough(coords, spans, n_real, (spare // ts.ntx, spare % ts.ntx))
    atlas = T.shatter_into(ts.atlas().clone(), moved.rgba, oys, oxs, base)
    args = ts.upload(coords, spans, didx)
    noise = torch.randint(-(2**31), 2**31 - 1, view.frame.shape, dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    frame_k, frame_p = noise.clone(), noise.clone()
    T.composite_dirty(*args, view.background, frame_k, atlas, n_slots)
    T.composite_dirty_torch(*args, view.background, frame_p, atlas, n_slots)
    torch.cuda.synchronize()
    require(torch.equal(frame_k, frame_p), "composite_dirty differs from composite_dirty_torch")
    sy, sx = (spare // ts.ntx) * 64, (spare % ts.ntx) * 128
    require(torch.equal(frame_k[sy : sy + 64, sx : sx + 128], noise[sy : sy + 64, sx : sx + 128]),
            "composite_dirty wrote a passthrough tile")
    dirty_err = max_abs_err(frame_k, frame_p)
    dirty_ms = event_ms(torch, lambda: T.composite_dirty(*args, view.background, frame_k, atlas, n_slots), scrub)
    dirty_plain_ms = event_ms(
        torch, lambda: T.composite_dirty_torch(*args, view.background, frame_p, atlas, n_slots), scrub
    )
    emit({"phase": "kernels", "tolerance": 0, "composite_full": {"equal": True, "tiles": ts.nty * ts.ntx,
                                                 "listed_pieces": n_listed, "ms": full_ms,
                                                 "plain_ms": full_plain_ms},
          "composite_dirty": {"equal": True, "slots": n_slots, "real_slots": n_real + 1,
                              "passthrough_tile": spare, "listed_pieces": int(spans[2 * n_real + 1]),
                              "ms": dirty_ms, "plain_ms": dirty_plain_ms}})
    return {"composite_full": (full_err, full_ms, full_plain_ms),
            "composite_dirty": (dirty_err, dirty_ms, dirty_plain_ms)}


def lion_path(torch, dev, kernels):
    """Phase 4: the lion's main path, counted from zero.  Returns the
    launch counts."""
    # The first frames on the CPU, through the plain versions.
    t0 = time.perf_counter()
    cview, cdisp, ckey = build_scene("cpu")
    cpu_build_s = time.perf_counter() - t0
    cpu_atlas = cview.ts.atlas().clone()
    cpu_alpha = cdisp.f_alpha.clone()
    cpu_display0 = cdisp.rgba.clone()
    for k in range(N_CHECK):
        cdisp.step_animated(ckey, *delta(k))
    cpu_display = cdisp.rgba.clone()
    del cview, cdisp

    zero_counts(torch, kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    view, disp, key = build_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(torch.equal(view.ts.atlas().cpu(), cpu_atlas), "card atlas differs from the CPU build")
    require(torch.equal(disp.f_alpha.cpu(), cpu_alpha), "card alpha plane differs from the CPU build")
    require(torch.equal(disp.rgba.cpu(), cpu_display0), "card full refresh differs from the CPU one")
    snapshot = []

    def frame(k):
        disp.step_animated(key, *delta(k))
        if k == N_CHECK - 1:
            snapshot.append(disp.rgba.clone())

    frame_ms, loop_s = timed_frames(torch, frame, N_FRAMES)
    require(torch.equal(snapshot[0].cpu(), cpu_display),
            f"display after {N_CHECK} frames differs from the CPU plain path")
    dirty_content = view.frame.clone()
    view.render(full=True)
    torch.cuda.synchronize()
    require(torch.equal(view.frame, dirty_content), "render(full=True) differs from the dirty-path content")
    require(tuple(disp.rgba.shape) == (H, W, 4) and disp.rgba.dtype == torch.int32, "display shape or type")
    require(bool(((disp.rgba >= 0) & (disp.rgba <= 255)).all()), "display channels outside 0..255")
    counts = dict(kernels.launches)
    require(counts["composite_dirty"] >= N_FRAMES + 1, f"composite_dirty launched {counts['composite_dirty']} times")
    require(counts["composite_full"] >= 1, "composite_full never launched on the main path")
    stats = frame_stats(frame_ms)
    emit({"phase": "main_path", "frames": N_FRAMES, "build_s": build_s, "cpu_reference_build_s": cpu_build_s,
          "first_frame_ms": stats["first_ms"], "frame_ms_median": stats["median_ms"],
          "frame_ms_p95": stats["p95_ms"], "host_ms_per_frame": loop_s / N_FRAMES * 1e3,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
          "display_equal_cpu_after_frames": N_CHECK, "full_render_equal_dirty": True})
    return counts


def interactive_path(torch, dev, kernels, scrub):
    """Phases 5 and 6: config 5 on the card, counted from zero, then
    composite_runs against its plain version and composite_full on the 1x
    scene's full-frame lists.  Returns (launch counts, (max_abs_err, ms,
    plain_ms) of composite_runs)."""
    from coherence_tpu_torch.raster import tiled_scene as T
    from coherence_tpu_torch.scene import fastframe

    # The first 3 filtered frames on the CPU, through the plain versions.
    t0 = time.perf_counter()
    cview, cdisp, ckey, _ = build_interactive("cpu")
    for k in range(3):
        filtered_frame(cview, cdisp, ckey, k)
    cpu_s = time.perf_counter() - t0
    cpu_atlas, cpu_pieces = scene_state(cview)
    cpu_display = cdisp.rgba.clone()
    del cview, cdisp

    zero_counts(torch, kernels)
    torch.cuda.reset_peak_memory_stats()
    fastframe.scene_build_cache_clear()
    fastframe.scene_build_cache_stats(reset=True)
    t0 = time.perf_counter()
    view, disp, key, objs = build_interactive(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for k in range(3):
        filtered_frame(view, disp, key, k)
    atlas, pieces = scene_state(view)
    require(pieces == cpu_pieces, "4K piece lists differ from the CPU run")
    require(torch.equal(atlas, cpu_atlas), "4K atlas differs from the CPU run")
    require(torch.equal(disp.rgba.cpu(), cpu_display), "4K display after 3 filtered frames differs from the CPU run")
    filtered_ms, filtered_s = timed_frames(torch, lambda k: filtered_frame(view, disp, key, k), N_FRAMES4)
    plain_ms, plain_s = timed_frames(torch, lambda k: plain_frame(view, key, k), N_FRAMES4)
    dirty_content = view.frame.clone()
    view.render(full=True)
    starts, idxs = view.ts.build_lists(view.order)
    runs_frame = view.ts.render_runs(view.background, starts, idxs)
    torch.cuda.synchronize()
    require(torch.equal(view.frame, dirty_content), "4K render(full=True) differs from the dirty-path content")
    require(torch.equal(runs_frame, view.frame), "4K render_runs differs from render(full=True)")
    # The 1x scene's lists and atlas, for the kernel checks after the zooms.
    atlas_1x, background = view.ts.atlas().clone(), view.background
    nty, ntx = view.ts.nty, view.ts.ntx
    zooms, cur = [], objs
    for rep in range(N_ZOOMS):
        f = 2.0 if rep % 2 == 0 else 0.5
        cur = zoomed(cur, f)
        t0 = time.perf_counter()
        view.reset_scene(cur)
        view.render(full=True)
        torch.cuda.synchronize()
        zooms.append({"factor": f, "seconds": time.perf_counter() - t0, "pieces": view.ts._n_pieces,
                      **fastframe.scene_build_cache_stats()})
    fastframe.scene_build_cache_stats(reset=True)
    t0 = time.perf_counter()
    view.prefetch_zoom_candidates(cur)
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t0
    half = zoomed(cur, 0.5)
    t0 = time.perf_counter()
    view.reset_scene(half)
    view.render(full=True)
    torch.cuda.synchronize()
    half_s = time.perf_counter() - t0
    half_stats = fastframe.scene_build_cache_stats()
    require(half_stats["hits"] == 1, f"the prefetched 0.5x step missed the scene-build cache: {half_stats}")
    require(bool((((view.frame >> 24) & 0xFF) == 255).all()), "4K frame over white is not opaque")
    counts = dict(kernels.launches)
    require(counts["composite_dirty"] >= 2 * N_FRAMES4, f"4K composite_dirty launched {counts['composite_dirty']}")
    require(counts["composite_full"] >= N_ZOOMS + 2, f"4K composite_full launched {counts['composite_full']}")
    require(counts["composite_runs"] >= 1, "composite_runs never launched on the 4K path")
    emit({"phase": "interactive_4k", "width": W4, "height": H4, "objects": len(objs) + 1,
          "pieces": sum(len(p) for p in pieces), "listed_pieces": int(starts[-1]), "build_s": build_s,
          "cpu_reference_s": cpu_s, "cpu_reference_size": [W4, H4], "filtered": frame_stats(filtered_ms),
          "filtered_host_ms_per_frame": filtered_s / N_FRAMES4 * 1e3, "plain": frame_stats(plain_ms),
          "plain_host_ms_per_frame": plain_s / N_FRAMES4 * 1e3, "zooms": zooms, "prefetch_s": prefetch_s,
          "prefetched_step_s": half_s, "prefetched_step_cache": half_stats,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
          "equal_cpu_after_frames": 3, "full_render_equal_dirty": True, "render_runs_equal_full": True})
    del view, disp, objs, cur, half, dirty_content, runs_frame
    fastframe.scene_build_cache_clear()

    runs = T.gather_runs(atlas_1x, idxs)
    runs_k = T.composite_runs(starts, background, runs, nty, ntx)
    runs_p = T.composite_runs_torch(starts, background, runs, nty, ntx)
    full = T.composite_full(starts, idxs, background, atlas_1x, nty, ntx)
    torch.cuda.synchronize()
    require(torch.equal(runs_k, runs_p), "composite_runs differs from composite_runs_torch")
    require(torch.equal(runs_k, full), "composite_runs differs from composite_full on the same lists")
    err = max_abs_err(runs_k, runs_p)
    ms = event_ms(torch, lambda: T.composite_runs(starts, background, runs, nty, ntx), scrub)
    plain_ms = event_ms(torch, lambda: T.composite_runs_torch(starts, background, runs, nty, ntx), scrub)
    emit({"phase": "kernels_4k", "tolerance": 0, "composite_runs": {
        "equal_plain": True, "equal_composite_full": True, "tiles": nty * ntx, "listed_pieces": int(starts[-1]),
        "runs_pieces": int(runs.shape[0]), "ms": ms, "plain_ms": plain_ms,
        "gather_runs_ms": event_ms(torch, lambda: T.gather_runs(atlas_1x, idxs), scrub),
        "composite_full_ms": event_ms(torch, lambda: T.composite_full(starts, idxs, background, atlas_1x, nty, ntx),
                                      scrub)}})
    return counts, (err, ms, plain_ms)


def layers_path(torch, dev, kernels, scrub):
    """Phase 7: config 2's stack over white through composite_layers,
    counted from zero, then the kernel against its plain version over
    white and over noise.  Returns (launch counts, (max_abs_err, ms,
    plain_ms))."""
    from coherence_tpu_torch.raster import compositor as PC
    from coherence_tpu_torch.scene import examples, fastframe

    stack = examples.hsr_layers(HSR_K, HSR_H, HSR_W, device=dev)
    white = fastframe._background((255, 255, 255, 255), HSR_H, HSR_W, dev)
    zero_counts(torch, kernels)
    layered = PC.composite_layers(white, stack)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts["composite_layers"] >= 1, "composite_layers never launched on the layer-stack path")
    want = PC.composite_layers_torch(white, stack)
    noise = torch.randint(-(2**31), 2**31 - 1, (HSR_H, HSR_W), dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    over_noise_k = PC.composite_layers(noise, stack)
    over_noise_p = PC.composite_layers_torch(noise, stack)
    torch.cuda.synchronize()
    require(torch.equal(layered, want), "composite_layers differs from composite_layers_torch over white")
    require(torch.equal(over_noise_k, over_noise_p), "composite_layers differs from composite_layers_torch over noise")
    require(bool((((layered >> 24) & 0xFF) == 255).all()), "the layer stack over white is not opaque")
    err = max(max_abs_err(layered, want), max_abs_err(over_noise_k, over_noise_p))
    ms = event_ms(torch, lambda: PC.composite_layers(white, stack), scrub)
    plain_ms = event_ms(torch, lambda: PC.composite_layers_torch(white, stack), scrub)
    # Layers each tile walks: down to the first layer under which every
    # pixel of the tile is opaque, else all of them.
    depth = torch.full((HSR_H, HSR_W), HSR_K, dtype=torch.int32, device=dev)
    for k in range(HSR_K - 1, -1, -1):
        depth = torch.where(((stack[k] >> 24) & 0xFF) == 255, k + 1, depth)
    walk = depth.view(HSR_H // 64, 64, HSR_W // 128, 128).amax(dim=(1, 3))
    emit({"phase": "hsr_layers", "layers": HSR_K, "height": HSR_H, "width": HSR_W, "tolerance": 0,
          "stack_mb": stack.numel() * 4 / 1e6, "launches": counts, "equal_plain_white": True,
          "equal_plain_noise": True, "ms": ms, "plain_ms": plain_ms,
          "mean_tile_walk_layers": float(walk.float().mean())})
    return counts, (err, ms, plain_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. Build.
    t0 = time.perf_counter()
    log = kernels.build()
    kernels.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})

    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB
    timed = lion_kernels(torch, dev, scrub)
    lion = lion_path(torch, dev, kernels)
    counts4, timed["composite_runs"] = interactive_path(torch, dev, kernels, scrub)
    counts_hsr, timed["composite_layers"] = layers_path(torch, dev, kernels, scrub)

    require("jax" not in sys.modules, "jax was imported")
    rows = [
        ("composite_dirty", SOURCE, "coherence_tpu/raster/tiled_scene.py:490", lion),
        ("composite_full", SOURCE, "coherence_tpu/raster/tiled_scene.py:379", lion),
        ("composite_runs", CSRC + "composite_runs.cu", "coherence_tpu/raster/tiled_scene.py:245", counts4),
        ("composite_layers", CSRC + "composite_layers.cu", "coherence_tpu/raster/pallas_compositor.py:101",
         counts_hsr),
    ]
    line = []
    for kname, source, replaces, counts in rows:
        err, ms, plain_ms = timed[kname]
        line.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[kname], "launches_4k": counts4[kname], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
    line[1]["also_replaces"] = "coherence_tpu/raster/tiled_scene.py:143"
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
