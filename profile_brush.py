#!/usr/bin/env python3
"""Time the brush kernels at the program's shapes on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_brush.py [--tree DIR]

--tree names the checkout whose package and ``chip_smoke.py`` run (by
default this one; it must have ``chip_smoke.brush_row``), so that one
call can hold two versions of the kernels on the same card: copy the other
checkout into a directory that ``.gitignore`` lists and run both in turns
(A, B, B, A).  At each of ``chip_smoke.brush_inputs``' shapes (plane mode
at the general renderer's 1013-stamp brush and a radius-120 brush, piece
mode at config 5's brush groups at 1x and 2x, the smear's 1024 steps) it
runs ``chip_smoke.brush_row``: the kernel against its plain version, bit
for bit, then both timed as ``chip_smoke.py`` times them (CUDA events,
cold L2, the kernel queued behind a device-side wait of max(1 ms, 4 x the
wrapper's slowest host call)).  It prints one JSON line: per shape the
kernel's ms, its plain version's and the wrapper's host ms, the launch
floor (an empty kernel timed the same way), the tree, and the card's name
and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package and chip_smoke.py)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("profile_brush: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from coherence_tpu_torch import kernels

    for mod in (cs, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"profile_brush: {mod.__name__} came from {mod.__file__}, not from {tree}")
    dev = "cuda"
    t0 = time.perf_counter()
    kernels.build()
    kernels.load()
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB, past the 50 MB L2
    rows = {}
    for name, (mode, inputs) in cs.brush_inputs(torch, dev).items():
        row = cs.brush_row(torch, dev, scrub, mode, inputs)
        rows[name] = {k: row[k] for k in ("ms", "plain_ms", "host_ms", "host_ms_max")}
    floor = cs.event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": tree, "shapes": rows, "launch_floor_ms": floor, "nvidia_smi": smi,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
