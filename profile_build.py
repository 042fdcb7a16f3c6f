#!/usr/bin/env python3
"""Time the port's tiled scene builds and zoom steps on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_build.py [--tree DIR] [--reps 3] [--out DIR] [--tr1-only]

--tree names the checkout whose package, ``chip_smoke.py``,
``profile_general.py`` and ``profile_interactive.py`` run (by default this
one), so that one call can hold two commits on the same card: unpack the
other with ``git archive`` into a directory that ``.gitignore`` lists and
run the two in turns (parent, change, change, parent).  Every build starts
cold: the coherence cache, the scene-build cache and, where the tree has
one, the sweep cache emptied first.  It prints one JSON line:

  * lion_build_s: ``chip_smoke.build_scene`` (the bench.py lion at
    1920x1080: tile build, blob sprite, filter alpha, full refresh),
    synchronized host clock, --reps builds;
  * config5_build_s: ``chip_smoke.build_interactive`` (config 5 at
    3840x2160), --reps builds;
  * lion_flush: one ``TileBuild.flush`` of the lion's staged items: its
    seconds (synchronized host clock, --reps flushes), its blocks, the
    launches and copies it issues (``profile_general.issued``) and one
    more flush under cProfile (its 25 largest cumulative rows into
    --out/flush_cprofile.txt, ``split``: the seconds of its parts that
    each tree has, the span packing ``tile_span_lists``, the staged copy
    ``stage``, the scatter ``mask_of_spans``, the table product
    ``coverage_counts``);
  * zoom_2x_miss_s and zoom_split: config 5's 2x zoom step (reset_scene and
    a full render) from 1x, missing the scene-build cache and (where the
    tree has one) the sweep cache, unprofiled --reps times, then once more
    under cProfile with ``profile_interactive.zoom_split``'s parts (the
    host sweep ``staging``, the tile rasterizer ``dispatch``, the brush
    ``stamp_scan``, the rest);
  * zoom_back: the step from 2x back to 1x under cProfile, its ``staging``
    part with the sweep cache as the steps before left it (sweep_cached),
    and again with the sweep cache emptied just before (sweep_cold), each
    with the sweep cache's hits and misses in the step (null where the
    tree has no sweep cache).

  * tr1: the tile rasterizer kernel at the lion's and config 5's build
    flush, as the tree's ``chip_smoke.tile_raster_row`` times it (the
    kernel's ms with the lists staged beforehand, each class's block
    alone, the wrapper's host_ms, the bound), with the launch floor
    (an empty kernel timed as the kernel is).  --tr1-only runs this part
    alone.

Beside them the card's name and power limit, as nvidia-smi prints them.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package and scripts)")
    ap.add_argument("--reps", type=int, default=3, help="builds and flushes timed")
    ap.add_argument("--out", default="build/profile_build", help="directory for the flush's cProfile rows")
    ap.add_argument("--tr1-only", action="store_true", help="time only the tile rasterizer kernel (tr1)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("profile_build: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import profile_general as pg
    import profile_interactive as pi
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import tile_raster
    from coherence_tpu_torch.scene import cache, examples, fastframe

    for mod in (cs, pg, pi, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"profile_build: {mod.__name__} came from {mod.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kernels.build()
    kernels.load()
    has_sweep = hasattr(tile_raster, "sweep_cache_clear")

    def cold():
        cache.clear()
        fastframe.scene_build_cache_clear()
        if has_sweep:
            tile_raster.sweep_cache_clear()

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def sweep_stats():
        return dict(tile_raster.sweep_cache_stats) if has_sweep else None

    def gained(before):
        return None if before is None else {k: tile_raster.sweep_cache_stats[k] - before[k] for k in before}

    tr1 = tr1_rows(torch, cs, kernels)
    if args.tr1_only:
        print(json.dumps({"tree": tree, "nvidia_smi": smi, "tr1": tr1}))
        return 0

    # A first build outside the timing: the kernels' first launches, allocator growth.
    cold()
    cs.build_scene("cuda")
    lion_s = []
    for _ in range(args.reps):
        cold()
        lion_s.append(seconds(lambda: cs.build_scene("cuda"))[0])
    big_s = []
    for _ in range(args.reps):
        cold()
        big_s.append(seconds(lambda: cs.build_interactive("cuda"))[0])

    objs, _, _ = examples.bench_scene(cs.W, cs.H, blob_radius=60, blob_at=(120, 400), f_box=cs.F_BOX)
    flush_s = []
    for _ in range(args.reps + 1):
        cold()
        tb = fastframe.stage_tiled_scene(-(-cs.H // 64), -(-cs.W // 128), cs.W, cs.H, [(o.idset, o) for o in objs],
                                         "cuda")[0]
        flush_s.append(seconds(tb.flush)[0])
    blocks = len(tb.flush()[0])
    flush_issued = pg.issued(torch, tb.flush)
    flush_prof_s, flush_stats = pi.cprofiled(lambda: (tb.flush(), torch.cuda.synchronize()))
    os.makedirs(args.out, exist_ok=True)
    pi.write_stats(os.path.join(args.out, "flush_cprofile.txt"), flush_prof_s, flush_stats)
    flush_split = {func: sum(row[3] for (path, _, f), row in flush_stats.stats.items() if f == func)
                   for func in ("tile_span_lists", "tile_raster_lists", "stage", "mask_of_spans", "coverage_counts")}

    cold()
    view, _, _, objs4 = cs.build_interactive("cuda")
    z2 = cs.zoomed(objs4, 2.0)

    def zoom(scene):
        view.reset_scene(scene, tiled=True)
        view.render(full=True)
        torch.cuda.synchronize()

    def misses_next():  # the next step misses the scene-build cache and sweeps every object
        fastframe.scene_build_cache_clear()
        if has_sweep:
            tile_raster.sweep_cache_clear()

    miss_s = []
    for _ in range(args.reps):
        misses_next()
        miss_s.append(seconds(lambda: zoom(z2))[0])
        zoom(objs4)  # back at 1x (rebuilt, untimed)
    misses_next()
    zoom(objs4)  # at 1x again: its objects in the sweep cache, as a user zooming in from 1x leaves them
    fastframe.scene_build_cache_clear()
    split_s, split_stats = pi.cprofiled(lambda: zoom(z2))
    back = cs.zoomed(z2, 0.5)
    before = sweep_stats()
    cached_s, cached_stats = pi.cprofiled(lambda: zoom(back))
    cached = {**pi.zoom_split(cached_stats, cached_s), "sweep": gained(before)}
    zoom(z2)  # a scene-build cache hit
    if has_sweep:
        tile_raster.sweep_cache_clear()
    before = sweep_stats()
    cold_s, cold_stats = pi.cprofiled(lambda: zoom(back))
    swept = {**pi.zoom_split(cold_stats, cold_s), "sweep": gained(before)}
    print(json.dumps({"tree": tree, "nvidia_smi": smi, "sweep_cache": has_sweep,
                      "lion_build_s": lion_s, "lion_build_s_median": statistics.median(lion_s),
                      "config5_build_s": big_s, "config5_build_s_median": statistics.median(big_s),
                      "lion_flush": {"s": flush_s[1:], "s_median": statistics.median(flush_s[1:]), "blocks": blocks,
                                     "issued": flush_issued, "profiled_s": flush_prof_s, "split": flush_split},
                      "zoom_2x_miss_s": miss_s, "zoom_2x_miss_s_median": statistics.median(miss_s),
                      "zoom_split": pi.zoom_split(split_stats, split_s),
                      "zoom_back": {"sweep_cached": cached, "sweep_cold": swept}, "tr1": tr1}))
    return 0


def tr1_rows(torch, cs, kernels) -> dict:
    """The tree's chip_smoke.tile_raster_row at the lion's and config 5's
    build (its inputs from tile_inputs), uncounted, with the launch floor."""
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device="cuda")  # 128 MiB: past the 50 MB L2
    floor_ms = cs.event_ms(torch, lambda: kernels.launch_floor("cuda"), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    keys = ("blocks", "items", "units", "slots", "ms", "blocks_ms", "blocks_alone_ms", "host_ms", "plain_ms",
            "bound_ms", "share", "list_bytes", "layout_bytes", "blocks_per_sm", "flush_issued")
    rows = cs.uncounted(kernels, lambda: {name: cs.tile_raster_row(torch, "cuda", scrub, tb)
                                          for name, tb in cs.tile_inputs(torch, "cuda").items()})
    return {"launch_floor_ms": floor_ms, **{name: {k: row.get(k) for k in keys} for name, row in rows.items()}}


if __name__ == "__main__":
    sys.exit(main())
