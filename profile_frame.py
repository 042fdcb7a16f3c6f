#!/usr/bin/env python3
"""What an animated frame issues and costs on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_frame.py [--tree DIR] [--frames 200]
    python3 profile_frame.py [--tree DIR] --chain-only [lion|config5] [--chain-reps 5]

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
    works;
  * chain: the device's time per frame with the frames queued ahead of the
    card (queued_chain: N_CHAIN frames behind one device-side wait, median
    of CHAIN_REPS), where each launch waits on the card's queue for the
    kernel before it, as it would in a CUDA graph of the step; each rep's
    display and content held bit for bit to a second scene stepped with a
    synchronize after every frame.

Last it prints the card's name and power limit.  The profiler slows the
host, so its window gives counts and device time, and the unprofiled
frames give the times.

--chain-only runs only one scene's chain (the lion's by default), at the
frames the full run at its default --frames times it on (the same frame
indices in every process, so that two trees run in turns compare frame
for frame, unless a rep is retaken: a retake runs the next frames), over
--chain-reps reps: one JSON line.  The frames' work
follows the blob's position (frame k moves it by ``chip_smoke.delta(k)``,
``delta4(k)`` in config 5), so each rep gives the blob's box before and
after its frames.
"""

import argparse
import json
import os
import subprocess
import sys
import time


# Frames a queued chain: 4-5 issued operations each (profile_general.issued),
# a few hundred queue entries, far inside the card's launch queue and the
# staging ring (raster/staging.py MAX_RING); and its repetitions.
N_CHAIN = 100
CHAIN_REPS = 5
# The first frame of a chain under --chain-only: where scene_line starts it
# at its default --frames (30 warm, 5 counted, 50 profiled and
# 200 timed frames).
CHAIN_FIRST = 285


def queued_chain(torch, cs, frame, state, reference, first: int = 0, n: int = N_CHAIN, reps: int = CHAIN_REPS) -> dict:
    """The device's time per frame of frame(state, k), k = first, first + 1,
    ..., n frames at a time queued behind one device-side wait
    (torch.cuda._sleep) and timed with CUDA events from the wait's end to
    the last frame's end, so that the window holds the frames' device work
    with every launch already queued: the median of `reps` (ms_per_frame),
    each reading.  First n frames run unqueued (their host time), then n
    queued and untimed, so that the staging ring has grown to hold n
    frames' pinned buffers; the timed wait is 3 x the slower of the two
    host times (at least 20 ms).  A rep whose host time to queue its
    frames outlasts half of its wait is taken again, on the next n frame
    indices, behind twice the wait ("retaken"), and a third such reading
    raises.  Every pass takes the next n indices, none twice, so the
    moved object is always where frame k puts it (a move by index, run
    twice, would carry it on, off the frame); "passes" counts the passes,
    retakes included, each scene ran.  The collector is off while a pass
    is queued, so that a collection is not a slow host.  After each pass
    the same frames run on `reference` (a second scene, built as `state`
    was) with a synchronize after each, and the two scenes' displays and
    content must be equal, bit for bit.  `state` and `reference` are
    (view, display, key of the moved object, ...); "boxes" gives that
    object's box before and after each rep's frames."""
    import gc
    import statistics

    def check(k0):
        for k in range(k0, k0 + n):
            frame(reference, k)
            torch.cuda.synchronize()
        cs.require(torch.equal(state[1].rgba, reference[1].rgba) and torch.equal(state[0].frame, reference[0].frame),
                   f"{n} queued frames from frame {k0} differ from the same frames run one by one")

    passes = [first]  # the first frame index of the next pass

    def next_pass():
        k0 = passes[-1]
        passes.append(k0 + n)
        return k0

    def queued(wait_ms):
        """(host ms to queue the next pass's frames, device ms per frame) behind a wait of wait_ms."""
        k0 = next_pass()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda._sleep(int(wait_ms * cs.sleep_cycles_per_ms(torch)))
            e0.record()
            t0 = time.perf_counter()
            for k in range(k0, k0 + n):
                frame(state, k)
            host_ms = (time.perf_counter() - t0) * 1e3
            e1.record()
        finally:
            if collecting:
                gc.enable()
        e1.synchronize()
        check(k0)
        return host_ms, e0.elapsed_time(e1) / n

    gc.collect()
    k0 = next_pass()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(k0, k0 + n):
        frame(state, k)
    torch.cuda.synchronize()
    unqueued_ms = (time.perf_counter() - t0) * 1e3
    check(k0)
    warm_ms = queued(max(20.0, 4 * unqueued_ms))[0]
    wait_ms = max(20.0, 3 * max(unqueued_ms, warm_ms))
    readings, host, boxes, retaken = [], [], [], 0
    for rep in range(reps):
        before = state[0].sprites[state[2]].box
        rep_wait = wait_ms
        host_ms, ms = queued(rep_wait)
        while host_ms >= rep_wait / 2:
            retaken += 1
            cs.require(retaken < 3, f"queueing {n} frames took {host_ms:.3f} ms of a {rep_wait:.3f} ms wait")
            rep_wait *= 2
            host_ms, ms = queued(rep_wait)
        readings.append(ms)
        host.append(host_ms)
        boxes.append([list(before), list(state[0].sprites[state[2]].box)])
    return {"frames": n, "reps": reps, "first": first, "passes": len(passes) - 1,
            "ms_per_frame": statistics.median(readings), "readings": readings, "boxes": boxes, "wait_ms": wait_ms,
            "unqueued_ms_per_frame": unqueued_ms / n, "warm_queue_host_ms": warm_ms, "queue_host_ms": host,
            "retaken": retaken, "equal_unqueued": True}


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
    reference = build()
    for k in range(35 + window + n):
        frame(reference, k)
    chain = queued_chain(torch, cs, frame, state, reference, first=35 + window + n)
    return {"scene": name, "issued": issued, "device_ops": device_ops, "device_ms": device_ms,
            **cs.frame_stats(ms), "host_ms_per_frame": host_ms, "busy": device_ms / host_ms, "chain": chain}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package, chip_smoke.py and profile_general.py)")
    ap.add_argument("--frames", type=int, default=200, help="unprofiled frames per scene")
    ap.add_argument("--chain-only", nargs="?", const="lion", choices=("lion", "config5"),
                    help="only this scene's queued chain")
    ap.add_argument("--chain-reps", type=int, default=CHAIN_REPS, help="reps of the queued chain (--chain-only)")
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

    if args.chain_only:
        build, frame = {"lion": (lambda: cs.build_scene("cuda"), lion_frame),
                        "config5": (lambda: cs.build_interactive("cuda"), config5_frame)}[args.chain_only]
        state, reference = build(), build()
        for k in range(CHAIN_FIRST):
            frame(state, k)
            frame(reference, k)
        chain = queued_chain(torch, cs, frame, state, reference, first=CHAIN_FIRST, reps=args.chain_reps)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps({"tree": tree, "scene": args.chain_only, "chain": chain, "nvidia_smi": smi,
                          "seconds": time.perf_counter() - t0}))
        return 0
    lines = [scene_line(torch, cs, pg, "lion", lambda: cs.build_scene("cuda"), lion_frame, args.frames),
             scene_line(torch, cs, pg, "config5", lambda: cs.build_interactive("cuda"), config5_frame, args.frames)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": tree, "scenes": lines, "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
