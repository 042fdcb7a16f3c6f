"""The control of the check: the reference put in the program's place with its
colour arithmetic (each dissolve, each over of the composite, the blur's sums)
in bfloat16 instead of exact integers, the lower precision that moving that
work onto tensor cores would tempt; judged by the same comparison at the same
sampled events as a run.  It breaks the configurations' stated guarantee of
exact integer colour, and the check must call it wrong.  The benchmark's own
runs never run it:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed with the numbers compared and their limits."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import bench, generator  # noqa: E402
from portbench.check import Snapshot, judge, states  # noqa: E402
from portbench.reference.render import Reference  # noqa: E402

LOWER = torch.bfloat16


def control_snapshots(desc: dict, traffic, device) -> list:
    """What the control would hand the check at the traffic's sampled
    events: its content, display and, zooming, pieces in an atlas of its own."""
    ctl = Reference(desc, device, dtype=LOWER)
    at = states(traffic, traffic.events(), traffic.snapshots)
    snaps, memo = [], {}
    for idx in traffic.snapshots:
        content, display, layers = traffic.module.outputs(ctl, desc, at[idx], memo)
        pieces = atlas = None
        if layers is not None:
            pieces, blocks = [], []
            for lay in layers:
                plist = []
                for t in sorted(lay.tiles) if lay is not None else ():
                    plist.append((t, len(blocks)))
                    blocks.append(ctl.piece(lay, t))
                pieces.append(plist)
            atlas = torch.stack(blocks) if blocks else torch.zeros((0, 64, 128), dtype=torch.int32, device=device)
        snaps.append(Snapshot(idx, content, display, pieces, atlas))
    return snaps


def control_numbers(cell: dict, config: dict, seed: int, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    traffic = generator.make(cell["traffic"], config, seed)
    scene = importlib.import_module(f"portbench.scenes.{config['scene']}")
    desc = scene.describe(config, seed)
    snaps = control_snapshots(desc, traffic, device)
    return judge(desc, traffic, traffic.events(), snaps, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell, cfg_entry, _, _ = bench.cell_of(bench.load_benchmark(), args.workload)
    config = bench.load_config(cfg_entry)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_numbers(cell, config, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": got["correct"],
                          "numbers": got["numbers"], "answers": got["answers"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
