#!/usr/bin/env python3
"""tile_raster (TR1) at the lion's and config 5's build flush, against other
builds of its source, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_tile.py [--variant NAME=FILE.cu ...]

The flushes are ``chip_smoke.tile_inputs``' (the lion at 1920x1080 and
config 5 at 3840x2160, every block of ``TileBuild.batches()``), staged once
by this checkout's ``kernels.stage_tile_lists``.  This checkout's wrapper
(``kernels.tile_raster``) rasterizes each; so does each variant, a
``tile_raster.cu`` with this checkout's entry point compiled alone by
``nvcc`` into ``build/tile_variants/`` and called through it on the same
lists.  First a JSON line per flush with its units and the blocks an SM
holds; then for each flush and variant one JSON line: equal to this
checkout's output or not (a variant made to see what a part costs may be
wrong on purpose), and its time in turns with this checkout's
(``chip_smoke.in_turns``: CUDA events, cold L2, each call queued behind a
device-side wait).  Last the ptxas lines of each build and the card's name
and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs
from profile_smear import compile_sources

VARIANT_DIR = os.path.join("build", "tile_variants")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", metavar="NAME=FILE", action="append", default=[],
                    help="a tile_raster.cu with this checkout's entry point (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_tile: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    logs = {"this": kernels.build()}
    kernels.load()
    sources = dict(v.split("=", 1) for v in args.variant)
    built = compile_sources(kernels, sources, VARIANT_DIR)
    logs.update({name: log for name, (_, log) in built.items()})
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(os.path.abspath(lib)).tile_raster
        fn.argtypes = [ptr] * 6 + [i32] * 2 + [ptr]
        fn.restype = i32
        entries[name] = fn
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device="cuda")  # 128 MiB, past the 50 MB L2
    for flush, tb in cs.tile_inputs(torch, "cuda").items():
        lists = kernels.stage_tile_lists([tb.kernel_lists(*b) for b in tb.batches()], "cuda")
        rows, cols, offsets, fills, units, n_items, slots = lists
        want = kernels.tile_raster(lists)
        cs.emit({"flush": flush, "units": int(units.shape[0]), "items": n_items, "slots": slots,
                 "blocks_per_sm": kernels.tile_raster_blocks_per_sm()})

        def launcher(fn):
            def call():
                out = torch.empty((slots, 64, 128), dtype=torch.int32, device="cuda")
                cs.require(fn(rows.data_ptr(), cols.data_ptr(), offsets.data_ptr(), fills.data_ptr(),
                              units.data_ptr(), out.data_ptr(), n_items, int(units.shape[0]), stream) == 0,
                           "a variant's launch failed")
                return out
            return call

        for name, fn in entries.items():
            got = launcher(fn)()
            torch.cuda.synchronize()
            turns = cs.in_turns(torch, lambda: kernels.tile_raster(lists), scrub, wait_ms=cs.ANIMATED_WAIT_MS,
                                **{name: launcher(fn)})
            cs.emit({"flush": flush, "variant": name, "source": sources[name], "equal": bool(torch.equal(got, want)),
                     **turns})
    ptxas = {}
    for who, log in logs.items():
        function = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties for" in ln:
                function = ln.split()[-1].strip("'") if "properties" in ln else ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln) and "tile_raster" in function:
                ptxas.setdefault(who, []).append(ln.strip())
    print(json.dumps({"ptxas_tile_raster": ptxas, "retaken": cs.RETAKEN[0]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
