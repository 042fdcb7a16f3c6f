#!/usr/bin/env python3
"""fold_layers at the three shapes the program gives it, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 profile_fold.py --save build/fold_shapes.pt
    python3 profile_fold.py --load build/fold_shapes.pt
    python3 profile_fold.py --load build/fold_shapes.pt --host-against build/parent

The shapes are those of ``chip_smoke.py``'s ``fold_kernel``
(``chip_smoke.fold_shapes``): the bench.py lion's 132 sprites over the whole
1920x1080 window; the lion group's fold in config 1's render; one
``recomposite_blur`` window of the lion under the radius-5 blur.  Without
``--load`` the script makes them by running ``chip_smoke.py``'s
``general_lion``, ``scene_edits`` and ``frame_path`` phases on the card (and
with ``--save`` writes them to a file); with ``--load`` it reads them, so
that two checkouts' kernels are timed on the same inputs in one call (parent,
change, change, parent).  Each shape goes through ``chip_smoke.fold_shape``:
bit for bit against the plain fold, whole and in two calls with the carry,
then the host's milliseconds per call, then CUDA events, median of 25, cold
L2, in turns with the plain fold, behind a device-side wait made from the
host's time; its bound.  With ``--host-against DIR`` each shape gets only
the host's milliseconds per call (``chip_smoke.fold_host_ms``) of this
checkout's ``kernels.fold_layers`` and of the one in the checkout at DIR
(loaded beside it, its library built there), in turns in one process (DIR's,
this, this, DIR's): a wrapper whose upload waits for the card can be held to
that too.  One JSON line per shape, then the card's name and power limit.
"""

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="write the shapes to this file")
    ap.add_argument("--load", help="read the shapes from this file instead of making them")
    ap.add_argument("--host-against", metavar="DIR",
                    help="time only the host's side of each call, against the fold wrapper of the checkout at DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_fold: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    dev = "cuda"
    kernels.build()
    kernels.load()
    if args.load:
        folds = torch.load(args.load)
    else:
        _, group_fold = cs.general_lion(torch, dev, kernels)
        _, lion = cs.scene_edits(torch, dev, kernels)
        _, blur_fold = cs.frame_path(torch, dev, kernels, lion)
        folds = cs.fold_shapes(torch, dev, lion["card"], group_fold, blur_fold)
        if args.save:
            torch.save({name: (offs, [(r.cpu(), m.cpu()) for r, m in layers], *(t.cpu() for t in carry))
                        for name, (offs, layers, *carry) in folds.items()}, args.save)
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB, past the 50 MB L2
    wrappers = {}
    if args.host_against:
        spec = importlib.util.spec_from_file_location(
            "against_kernels", os.path.join(args.host_against, "coherence_tpu_torch", "kernels", "__init__.py"))
        against = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(against)
        wrappers = {"against": against.fold_layers, "this": kernels.fold_layers}
    for name, fold in folds.items():
        if wrappers:
            offs, layers, *carry = fold
            layers = [(r.to(dev).contiguous(), m.to(dev).contiguous()) for r, m in layers]
            carry = [t.to(dev).contiguous() for t in carry]
            order = ["against", "this", "this", "against"]
            for who in wrappers:
                wrappers[who](offs, layers, *carry)  # one untimed call each first
            readings = [cs.fold_host_ms(torch, lambda: wrappers[who](offs, layers, *carry)) for who in order]
            row = {f"{who}_host_ms": statistics.mean(r["host_ms"] for w, r in zip(order, readings) if w == who)
                   for who in wrappers}
            row["readings"] = [[who, r["host_ms"], r["host_ms_max"]] for who, r in zip(order, readings)]
        else:
            row = cs.fold_shape(torch, dev, scrub, fold)
        cs.emit({"shape": name, **row})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
