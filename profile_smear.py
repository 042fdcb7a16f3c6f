#!/usr/bin/env python3
"""smear_walk (SM1) at the smear demo's walk, against other builds of its
source, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_smear.py [--first FILE.cu] [--variant NAME=FILE.cu ...]

The walk is ``profile_general.py``'s smear program (1024 steps of a 31x31
patch over its 675x775 canvas, two passes), as ``chip_smoke.py``'s
``brush_kernels`` times it.  This checkout's wrapper (``kernels.smear_walk``)
runs it; so does each other source, compiled alone by ``nvcc`` into
``build/smear_variants/`` and called through its C entry point on the same
inputs: ``--first`` a source with the first design's entry point (no
height, no stats: global mode only, the first design), ``--variant`` one with
this checkout's.  First a JSON line with the walk's shape and this
checkout's mode, window and reloads, as its kernel counted them; then for
each other build one JSON line: equal to the
plain version or not (a variant made to see what a part costs may be
wrong on purpose), and its time in turns with this checkout's wrapper
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

VARIANT_DIR = os.path.join("build", "smear_variants")


def compile_sources(kernels, sources: dict, directory: str = VARIANT_DIR) -> dict:
    """name -> (library path, nvcc's output) for each name -> .cu source,
    one nvcc each into `directory`, all started together."""
    os.makedirs(directory, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(directory, f"{name}.so")
        procs[name] = (lib, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        cs.require(proc.returncode == 0, f"nvcc failed on {sources[name]}:\n{log}")
        out[name] = (lib, log)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="FILE", help="a smear.cu with the first design's entry point")
    ap.add_argument("--variant", metavar="NAME=FILE", action="append", default=[],
                    help="a smear.cu with this checkout's entry point (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_smear: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import brush, staging
    from profile_general import programs, recorded_brush_calls

    dev = "cuda"
    logs = {"this": kernels.build()}
    kernels.load()
    sources = dict(v.split("=", 1) for v in args.variant)
    if args.first:
        sources["first"] = args.first
    built = compile_sources(kernels, sources)
    logs.update({name: log for name, (_, log) in built.items()})

    with recorded_brush_calls() as calls:
        programs(torch, dev)["smear"][2]()
    cv, opac, offsets, dirs, bh, bw = next(a for n, a in calls if n == "_smear_walk")
    height, width = cv.shape[:2]
    want = brush._smear_walk_torch(cv.clone(), opac, offsets, dirs, bh, bw)
    steps = kernels.smear_steps(offsets, dirs, bh, bw, height, width)
    (steps_d,) = staging.stage(dev, steps)
    spill = torch.empty((bh * bw, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def entry(name):
        fn = ctypes.CDLL(os.path.abspath(built[name][0])).smear_walk
        if name == "first":
            fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            return lambda c: fn(c.data_ptr(), width, opac.data_ptr(), steps_d.data_ptr(), spill.data_ptr(),
                                len(steps), kernels.SMEAR_PASSES, bh, bw, stream)
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr] + [i32] * 4 + [ptr]
        return lambda c: fn(c.data_ptr(), height, width, opac.data_ptr(), steps_d.data_ptr(), spill.data_ptr(), None,
                            len(steps), kernels.SMEAR_PASSES, bh, bw, stream)

    work = {"this": cv.clone()}
    calls_ = {"this": lambda: brush._smear_walk(work["this"], opac, offsets, dirs, bh, bw)}
    equal = {}
    for name in built:
        launch = entry(name)
        work[name] = cv.clone()
        once = cv.clone()
        cs.require(launch(once) == 0, f"{name}: the launch failed")
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(once, want))

        def call(name=name, launch=launch):
            cs.require(launch(work[name]) == 0, f"{name}: the launch failed")

        calls_[name] = call
    once = cv.clone()
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    kernels.smear_walk(once, opac, offsets, dirs, bh, bw, stats=stats)
    torch.cuda.synchronize()
    equal["this"] = bool(torch.equal(once, want))
    cs.require(equal["this"], "this checkout's smear_walk differs from its plain version")
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB, past the 50 MB L2
    host = cs.fold_host_ms(torch, calls_["this"])
    wait_ms = max(cs.ANIMATED_WAIT_MS, 4 * host["host_ms_max"])
    shape = {"canvas": [height, width], "patch": [bh, bw], "steps": len(steps),
             **cs.smear_mode(stats, kernels.SMEAR_PASSES * len(steps))}
    cs.emit({"shape": shape, "equal_plain": equal, "wait_ms": wait_ms, "host_ms": host["host_ms"]})
    for name in built:
        turns = cs.in_turns(torch, calls_["this"], scrub, wait_ms=wait_ms, **{name: calls_[name]})
        cs.emit({"variant": name, "source": sources[name], "equal_plain": equal[name], **turns})
    ptxas = {}
    for who, log in logs.items():
        function = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties for" in ln:
                function = ln.split()[-1].strip("'") if "properties" in ln else ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln) and "smear" in function:
                ptxas.setdefault(who, []).append(f"{function[-40:]}: {ln.strip()}")
    print(json.dumps({"ptxas_smear": ptxas, "retaken": cs.RETAKEN[0]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
