#!/usr/bin/env python3
"""Profile the port on config 5 (the interactive 4K scene) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_interactive.py [--out build/profile] [--frames 50] [--tree DIR]

--tree names the checkout whose package and ``chip_smoke.py`` run (by
default this one), so that one call can hold two commits on the same card:
unpack the other with ``git archive`` into a directory that ``.gitignore``
lists and run both in turns.  It builds the scene as ``chip_smoke.py``
does and writes, under --out:

  * build_cprofile.txt: cProfile of the scene build and full refresh;
  * frames_profile.txt: a ``torch.profiler`` window of --frames filtered
    frames after 30 warm ones: device time and device operations per
    frame (device rows only: the ``aten::`` rows repeat their kernels'
    time), and the profiler's table;
  * device_rows.txt: every device row, per frame, largest first;
  * zoom_cprofile.txt: cProfile of one 2x zoom step (a cache miss).

It prints, last, one JSON line with those totals, the host milliseconds
per filtered frame over 100 unprofiled frames, the zoom miss's split
(zoom_split: the cumulative seconds under cProfile of the brush-tile
build, ``BrushTileBuild.flush``, the stamp scan and its pieces; the host
sweep, ``stage_tiled_scene``, the staging; the tile rasterizer's
launches, ``TileBuild.flush``, the dispatch; and the rest of the step),
and the card's name and power limit.  The profiler adds tens of milliseconds per frame on the
host, so read its window for shares, not times.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time


def write_stats(path: str, seconds: float, stats) -> None:
    """The 25 largest cumulative rows of `stats` into `path`."""
    out = io.StringIO()
    stats.stream = out
    stats.sort_stats("cumtime").print_stats(25)
    with open(path, "w") as f:
        f.write(f"seconds {seconds}\n{out.getvalue()}")


def cprofile_to(path: str, fn) -> float:
    """Run fn under cProfile, write the 25 largest cumulative rows to
    `path`, and return its seconds on the host clock."""
    seconds, stats = cprofiled(fn)
    write_stats(path, seconds, stats)
    return seconds


# zoom_split's parts: name -> (file, function) of the cProfile row whose
# cumulative seconds it reads.
ZOOM_PARTS = {
    "stamp_scan": ("brush_tiles.py", "flush"),
    "staging": ("fastframe.py", "stage_tiled_scene"),
    "dispatch": ("tile_raster.py", "flush"),
}


def cprofiled(fn):
    """(seconds on the host clock, pstats.Stats) of fn under cProfile."""
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    fn()
    pr.disable()
    return time.perf_counter() - t0, pstats.Stats(pr)


def zoom_split(stats, seconds: float) -> dict:
    """ZOOM_PARTS' cumulative seconds from one cProfile of a zoom step, and
    the rest of its `seconds`."""
    parts = {name: sum(row[3] for (path, _, func), row in stats.stats.items()
                       if os.path.basename(path) == fname and func == want)
             for name, (fname, want) in ZOOM_PARTS.items()}
    return {**parts, "rest": seconds - sum(parts.values()), "total": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile", help="directory for the profile files")
    ap.add_argument("--frames", type=int, default=50, help="filtered frames in the profiler window")
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package and chip_smoke.py)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_interactive: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from coherence_tpu_torch import kernels

    for mod in (cs, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"profile_interactive: {mod.__name__} came from {mod.__file__}, not from {tree}")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kernels.build()
    kernels.load()
    built = {}

    def build():
        built["scene"] = cs.build_interactive("cuda")
        torch.cuda.synchronize()

    build_s = cprofile_to(os.path.join(args.out, "build_cprofile.txt"), build)
    view, disp, key, objs = built["scene"]
    for k in range(30):
        cs.filtered_frame(view, disp, key, k)
    torch.cuda.synchronize()

    n = args.frames
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            cs.filtered_frame(view, disp, key, 30 + k)
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    ka = prof.key_averages()
    # Device rows: kernels and copies.  The aten:: rows repeat their
    # kernels' time, and the runtime rows (cudaLaunchKernel, the profiler's
    # own buffers) are host calls.
    rows = [e for e in ka if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "cuda", "Activity Buffer"))]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    device_ops = sum(e.count for e in rows) / n
    with open(os.path.join(args.out, "device_rows.txt"), "w") as f:
        f.write("\n".join(f"{e.count / n:8.2f}/frame {e.self_device_time_total / n:10.3f} us/frame  {e.key[:110]}"
                          for e in sorted(rows, key=lambda e: -e.self_device_time_total)))
    with open(os.path.join(args.out, "frames_profile.txt"), "w") as f:
        f.write(f"{smi}\nframes {n} profiled_s {profiled_s} device_ms_per_frame {device_ms} "
                f"device_ops_per_frame {device_ops}\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=30))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(100):
        cs.filtered_frame(view, disp, key, 30 + n + k)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 100 * 1e3

    def zoom():
        view.reset_scene(cs.zoomed(objs, 2.0), tiled=True)
        view.render(full=True)
        torch.cuda.synchronize()

    zoom_s, zoom_stats = cprofiled(zoom)
    write_stats(os.path.join(args.out, "zoom_cprofile.txt"), zoom_s, zoom_stats)
    print(json.dumps({"tree": tree, "nvidia_smi": smi, "build_s": build_s, "device_ms_per_frame": device_ms,
                      "device_ops_per_frame": device_ops, "host_ms_per_frame_unprofiled": host_ms,
                      "zoom_2x_miss_s": zoom_s, "zoom_split": zoom_split(zoom_stats, zoom_s)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
