#!/usr/bin/env python3
"""What an animated frame issues and costs on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_frame.py [--tree DIR] [--frames 200]

--tree names the checkout whose package, ``chip_smoke.py`` and
``profile_general.py`` run (by default this one), so that one call can
hold two commits on the same card: unpack the other with ``git archive``
into a directory that ``.gitignore`` lists and run both in turns.  For two
scenes, each built as ``chip_smoke.py`` builds it and warmed by 30 frames:

  * lion: ``bench.py``'s lion at 1920x1080, the blob dragged by
    ``FilteredDisplay.step_animated`` under the radius-5 blur band;
  * config5: the interactive 4K scene, ``translate_object`` + the filtered
    ``step`` (``chip_smoke.filtered_frame``);

it prints one JSON line with:

  * issued: the launches and copies the host issues for each of 5 steady
    frames (``profile_general.issued``: the CUDA runtime's rows);
  * device_ops, device_ms: per frame, over a ``torch.profiler`` window of
    50 frames (device rows only, as ``profile_interactive.py`` counts);
  * frame median and p95 (CUDA events around each frame) and host ms per
    frame (host clock over the frames, synchronized at the end), over
    --frames unprofiled frames;
  * busy: device_ms over host ms per frame, the share of a frame the card
    works.

Last it prints the card's name and power limit.  The profiler slows the
host, so its window gives counts and device time, and the unprofiled
frames give the times.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def scene_line(torch, cs, pg, name, build, frame, n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    state = build()
    for k in range(30):
        frame(state, k)
    torch.cuda.synchronize()
    issued = [pg.issued(torch, lambda k=k: frame(state, k)) for k in range(30, 35)]
    window = 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(window):
            frame(state, 35 + k)
        torch.cuda.synchronize()
    rows = pg.device_rows(prof)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / window
    device_ops = sum(e.count for e in rows) / window
    ms, seconds = cs.timed_frames(torch, lambda k: frame(state, 35 + window + k), n)
    host_ms = seconds / n * 1e3
    return {"scene": name, "issued": issued, "device_ops": device_ops, "device_ms": device_ms,
            **cs.frame_stats(ms), "host_ms_per_frame": host_ms, "busy": device_ms / host_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package, chip_smoke.py and profile_general.py)")
    ap.add_argument("--frames", type=int, default=200, help="unprofiled frames per scene")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import profile_general as pg
    from coherence_tpu_torch import kernels

    for mod in (cs, pg, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"profile_frame: {mod.__name__} came from {mod.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    kernels.load()
    t0 = time.perf_counter()

    def lion_frame(state, k):
        _, disp, key = state
        disp.step_animated(key, *cs.delta(k))

    def config5_frame(state, k):
        view, disp, key, _ = state
        cs.filtered_frame(view, disp, key, k)

    lines = [scene_line(torch, cs, pg, "lion", lambda: cs.build_scene("cuda"), lion_frame, args.frames),
             scene_line(torch, cs, pg, "config5", lambda: cs.build_interactive("cuda"), config5_frame, args.frames)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": tree, "scenes": lines, "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
