#!/usr/bin/env python3
"""caf (CF1) and box_morph (MR1) at the general renderer's shapes on one
CUDA card: against another checkout's design in turns, their time split
into parts, and each block's span on the card's global timer.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_region.py [--parent DIR] [--split] [--timeline] [--tiny] [--warm]

The shapes are ``chip_smoke.region_kernels``' timed calls, recorded from
``general_filters``' whole-window render and first dragged frame
(``chip_smoke.region_inputs``): CF1 at the last frame over a white
1920 x 1080 window, the largest caf of two operands and the median caf
(``caf_timed_calls``, each caught at ``kernels.caf``'s arguments); MR1 at
each distinct bloat and erosion and at ``morph_second_route``'s synthetic
call, past one block's shared memory (``morph_timed_calls``).  Every time
is CUDA events, cold L2, each call queued behind a device-side wait of
max(1 ms, 4 x its slowest host call) (``chip_smoke.event_ms``).

The default mode times each shape's kernel through its wrapper, and the
wrapper's host side alone (``host_ms``: median and quartiles).  With
--parent DIR, DIR's package is loaded by path beside this one
(``profile_sprite.load_tree``: its library built in DIR's own ``build/``)
and each shape is timed in turns with DIR's design on the same inputs
(``chip_smoke.in_turns``: parent, this, this, parent); the two designs'
outputs must be equal.

--split compiles this checkout's ``region_ops.cu`` (and DIR's with
--parent) into ``build/region_variants/`` as probes that stop after one
part each (``STOPS``; wrong on purpose) and times each in turns with the
tree's own kernel: for MR1 ``launch`` (the launch alone), ``loads`` (the
source reads alone: the first design's walk with no scan, the second's
staging and bit packing) and ``scan`` (the first design's scans and
barriers over values made in registers; the second's staging and row
pass, no column pass or write); for CF1 ``launch``, ``masks`` (the mask
loads alone) and ``colours`` (every load and the composition, no
store).  --timeline runs
each whole kernel once more with every block's start and end recorded on
the global timer (``%globaltimer``) and its SM: the launch's span, the
blocks' durations and the start spread.  --tiny adds a caf of two 1 x 1
operands and a bloat of a 1 x 1 mask (one block, a few bytes: the fixed
cost of each kernel's code path); --warm leaves L2 warm between calls (a
4-byte scrub), so that data and code come from L2.  Last each build's
registers and static shared memory (ptxas).

Each mode prints JSON lines and, last, one with the launch floor (an empty
kernel timed alike) and the card's name and power limit.  Then take the
``general_filters`` incremental frame in turns with ``profile_sprite.py
--e2e --tree DIR``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

from profile_sprite import load_tree, wait_for

VARIANT_DIR = os.path.join("build", "region_variants")
PROBE_BLOCKS = 1 << 15  # the timeline probe's records (a launch of more blocks records its first ones)
KERNELS = {"caf": "caf_kernel", "box_morph": "box_morph_kernel"}


def tiny_shapes(torch, kernels, dev) -> list:
    """--tiny's shapes: a caf of two 1 x 1 operands and a radius-5 bloat of
    a 1 x 1 mask, each one block whose data is a few bytes: the fixed cost
    of a kernel's code path."""
    one = torch.ones((1, 1), dtype=torch.bool, device=dev)
    rgba = torch.full((1, 1, 4), 255, dtype=torch.int32, device=dev)
    plane = kernels.CafPlane(0, 0, one, rgba)
    return [("caf_tiny_1x1", "caf", ((1, 1, kernels.CAF_OPS["over"], plane, plane), {})),
            ("bloat_tiny_1x1_r5_5", "box_morph", (one, 5, 5, False))]


def shapes(torch, cs, kernels, dev, tiny: bool = False) -> list:
    """[(name, kernel, args)]: kernels.caf's (args, kw) of each timed caf,
    (mask, rx, ry, erode) of each timed box_morph; with `tiny`
    tiny_shapes' too."""
    from coherence_tpu_torch.raster import region

    calls, last_frame = cs.region_inputs(torch, dev)
    out = tiny_shapes(torch, kernels, dev) if tiny else []
    real = kernels.caf
    for label, call in zip(("window", "largest_two", "median"), cs.caf_timed_calls(torch, dev, calls, last_frame)):
        got = []
        kernels.caf = lambda *a, **kw: (got.append((a, kw)), real(*a, **kw))[1]
        try:
            region._caf_card(*call)
        finally:
            kernels.caf = real
        h, w = got[0][0][:2]
        out.append((f"caf_{label}_{h}x{w}", "caf", got[0]))
    for (mask, rx, ry), kw in cs.morph_timed_calls(torch, dev, calls):
        mode = "erode" if kw["erode"] else "bloat"
        out.append((f"{mode}_{mask.shape[0]}x{mask.shape[1]}_r{rx}_{ry}", "box_morph", (mask, rx, ry, kw["erode"])))
    return out


def caller(k, kernel: str, args):
    """A call of tree `k`'s wrapper on `args` (caf's planes as its own
    CafPlane)."""
    if kernel == "box_morph":
        mask, rx, ry, erode = args
        return lambda: k.box_morph(mask, rx, ry, erode=erode)
    a, kw = args
    a = tuple(k.CafPlane(*x) if isinstance(x, tuple) else x for x in a)
    return lambda: k.caf(*a, **kw)


def route_of(k, args) -> object:
    """MR1's route at `args` where tree `k` has more than one, else None."""
    mask, rx, ry, erode = args
    return k.box_morph_route(*mask.shape, rx, ry, erode)._asdict() if hasattr(k, "box_morph_route") else None


def same_output(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def compare(torch, cs, trees, scrub, dev: str, tiny: bool) -> None:
    """The default mode: per shape each tree's kernel, in turns."""
    kernels = trees["this"]
    for name, kernel, args in shapes(torch, cs, kernels, dev, tiny):
        calls = {who: caller(k, kernel, args) for who, k in trees.items()}
        row = {"shape": name, "kernel": kernel}
        if kernel == "box_morph":
            row.update({f"{who}_route": route_of(k, args) for who, k in trees.items()})
        else:
            row["this_one_trip"] = kernels.caf_one_trip(*args[0][:2])
        outs = {}
        for who, c in calls.items():
            before = trees[who].launches[kernel]
            outs[who] = c()
            row[f"{who}_launches"] = trees[who].launches[kernel] - before
        torch.cuda.synchronize()
        if "parent" in outs:
            row["equal_parent"] = same_output(torch, outs["this"], outs["parent"])
            cs.require(row["equal_parent"], f"profile_region: {name} differs from the parent's design")
        wait = wait_for(torch, cs, *calls.values())
        got = cs.in_turns(torch, calls["this"], scrub, wait_ms=wait,
                          **{who: c for who, c in calls.items() if who != "this"})
        cs.emit({**row, "wait_ms": wait, **got, **host_ms(torch, calls)})


def host_ms(torch, calls, rounds: int = 30) -> dict:
    """{tree + "_host_ms": (median, quartiles)}: each tree's wrapper on the
    host clock, not waited for, in rounds of parent, this, this, parent,
    the card synchronized after each round."""
    import statistics

    order = [*(w for w in calls if w != "this"), "this", "this", *(w for w in calls if w != "this")]
    spent = {who: [] for who in calls}
    for _ in range(rounds):
        for who in order:
            t0 = time.perf_counter()
            calls[who]()
            spent[who].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {f"{who}_host_ms": [statistics.median(v), *statistics.quantiles(v, n=4)[::2]] for who, v in spent.items()}


# Probe stops: name -> recipes, each a list of (text, replacement) edits of
# region_ops.cu; the first recipe whose texts are all in the source is
# applied.  The first recipe of each is the first design's.
STOPS = {
    ("box_morph", "loads"): [
        [("      // Inclusive max-scan over the block, on top of the carry.\n", "      probe_sink ^= v;\n#if 0\n"),
         ("      carry = last_col[kMorphCols - 1];\n      __syncthreads();\n",
          "      carry = last_col[kMorphCols - 1];\n      __syncthreads();\n#endif\n"),
         ("  unsigned bits = 0;           // output rows of the tile whose window held it\n",
          "  unsigned bits = 0;           // output rows of the tile whose window held it\n  int probe_sink = 0;\n"),
         ("  if (X >= p.W) return;\n", "  bits ^= static_cast<unsigned>(probe_sink);\n  if (X >= p.W) return;\n")],
    ],
    ("box_morph", "scan"): [
        [("(p.src[y * p.sy + (c + s0) * p.sx] != 0) == want", "(((c + y) & 1) != 0) == want")],
    ],
    ("caf", "masks"): [
        [("    int4 out = make_int4(0, 0, 0, 0);\n",
          "    if (static_cast<int>(ma) + static_cast<int>(mb) == p.op + 3) p.out_f[0] = 1;\n    continue;\n"
          "    int4 out = make_int4(0, 0, 0, 0);\n")],
    ],
    ("caf", "colours"): [
        [("    const long long i = static_cast<long long>(y) * p.w + x;\n",
          "    if (u(out.x) + u(out.y) + u(out.z) + u(out.w) == u(p.h) * 31u + 0x40000001u) p.out_f[0] = 1;\n"
          "    continue;\n    const long long i = static_cast<long long>(y) * p.w + x;\n")],
    ],
}
# The second designs' stops: MR1's loads are its staging (the loads and the
# bit packing into shared memory), its scan the staging, prefix counts and
# row pass; CF1's masks its mask bytes alone.
MR1_STAGED = "    stage(p, bits, held, r0 + lo, sb, want, lane, warp);\n    __syncthreads();\n"
MR1_ROWS = "      if (lane == 0) rowp[r * kMorphWords + j] = word;\n    }\n    __syncthreads();\n"
MR1_KEEP = "    if (p.sw < 0 && threadIdx.x == 0) p.out[0] = %s[0];\n    continue;\n"
CF1_ONE_TRIP = "      const int4 ca = in_a ? colour_at(p.a, y, x) : zero, cb = in_b ? colour_at(p.b, y, x) : zero;\n"
CF1_TWO_TRIPS = "      out = zero;\n      if (sa && sb) {\n"
STOPS[("box_morph", "loads")].append([(MR1_STAGED, MR1_STAGED + MR1_KEEP % "bits")])
STOPS[("box_morph", "scan")].append([(MR1_ROWS, MR1_ROWS + MR1_KEEP % "rowp")])
STOPS[("caf", "masks")].append([(CF1_ONE_TRIP, "      if ((ra ^ rb) == p.op + 7) p.out_f[0] = 1;\n      continue;\n" + CF1_ONE_TRIP),
                                (CF1_TWO_TRIPS, "      if (sa == sb && p.op > 7) p.out_f[0] = 1;\n      continue;\n" + CF1_TWO_TRIPS)])
# (The first design's colours stop, before the stores, fits the second too.)

PROBE_HEAD = """
// probe: the timeline's records, (start, end, SM) a block.
__device__ long long probe_timeline[%(blocks)d][3];
__device__ __forceinline__ long long probe_now() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
// The last of the block's threads to leave records the block.
__device__ __forceinline__ void probe_end(long long* t0, unsigned* left) {
  const unsigned n = blockDim.x * blockDim.y * blockDim.z;
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  if (atomicAdd(left, 1u) == n - 1 && b < %(blocks)d) {
    unsigned smid;
    asm("mov.u32 %%0, %%%%smid;" : "=r"(smid));
    probe_timeline[b][0] = *t0, probe_timeline[b][1] = probe_now(), probe_timeline[b][2] = smid;
  }
}
""" % {"blocks": PROBE_BLOCKS}
PROBE_TAIL = """
extern "C" int probe_timeline_reset() {
  static long long zeros[%(blocks)d][3];
  return static_cast<int>(cudaMemcpyToSymbol(probe_timeline, zeros, sizeof(zeros)));
}
extern "C" int probe_timeline_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, probe_timeline, 24L * %(blocks)d));
}
""" % {"blocks": PROBE_BLOCKS}
TIMELINE_START = ("  __shared__ long long probe_t0;\n  __shared__ unsigned probe_left;\n"
                  "  if (threadIdx.x == 0 && threadIdx.y == 0) probe_t0 = probe_now(), probe_left = 0;\n"
                  "  __syncthreads();\n")
TIMELINE_END = "{ probe_end(&probe_t0, &probe_left); return; }"


def kernel_body(src: str, kernel: str):
    """(head, body, tail) of `src` around the body of the __global__
    function `kernel`: body from after its opening brace to before its
    closing one (a brace alone on a line)."""
    m = re.search(r"__global__ void[^;{]*?\b%s\(" % kernel, src)
    if m is None:
        raise RuntimeError(f"profile_region: no __global__ {kernel} in region_ops.cu")
    start = src.index("{\n", m.end()) + 2
    end = src.index("\n}\n", start) + 1
    return src[:start], src[start:end], src[end:]


def probe_sources(csrc: str, directory: str) -> dict:
    """(kernel, probe) -> .cu path: probes of `csrc`/region_ops.cu (every
    entry point unchanged), each written into a directory of its own."""
    with open(os.path.join(csrc, "region_ops.cu")) as f:
        src = f.read()
    edits = {}
    for kernel, fn in KERNELS.items():
        head, body, tail = kernel_body(src, fn)
        edits[kernel, "launch"] = head + "  return;\n" + body + tail
        timed = body.replace("return;", TIMELINE_END)
        edits[kernel, "timeline"] = (head.replace("namespace {\n", PROBE_HEAD + "namespace {\n", 1) + TIMELINE_START
                                     + timed + "  " + TIMELINE_END + "\n" + tail + PROBE_TAIL)
    for (kernel, probe), recipes in STOPS.items():
        for recipe in recipes:
            if all(old in src for old, _ in recipe):
                text = src
                for old, new in recipe:
                    text = text.replace(old, new, 1)
                edits[kernel, probe] = text
                break
        else:
            raise RuntimeError(f"profile_region: no recipe of the {kernel} {probe} probe fits {csrc}/region_ops.cu")
    out = {}
    for (kernel, probe), text in edits.items():
        d = os.path.join(directory, f"{kernel}_{probe}")
        os.makedirs(d, exist_ok=True)
        out[kernel, probe] = os.path.join(d, "region_ops.cu")
        with open(out[kernel, probe], "w") as f:
            f.write(text)
    return out


def through(k, lib: str, call, entries):
    """`call` with tree `k`'s entry points `entries` taken from the built
    probe `lib` (same arguments as the tree's own)."""
    so = ctypes.CDLL(os.path.abspath(lib))
    fns = {}
    for e in entries:
        fns[e] = getattr(so, e)
        fns[e].argtypes = k._ENTRY_POINTS[e]
        fns[e].restype = ctypes.c_int
    k.load()

    def run():
        saved = k._fns
        k._fns = {**saved, **fns}
        try:
            return call()
        finally:
            k._fns = saved
    return run


def timeline_stats(torch, lib: str, run) -> dict:
    """One call of `run` through the timeline probe `lib` -> the launch's
    span, the blocks' durations and start spread, the blocks an SM ran."""
    import numpy as np

    so = ctypes.CDLL(os.path.abspath(lib))
    torch.cuda.synchronize()
    rc = so.probe_timeline_reset()
    run()
    torch.cuda.synchronize()
    rec = np.zeros((PROBE_BLOCKS, 3), np.int64)
    rc = rc or so.probe_timeline_read(ctypes.c_void_p(rec.ctypes.data))
    if rc != 0:
        raise RuntimeError(f"profile_region: the timeline probe's copy failed with CUDA error {rc}")
    rec = rec[rec[:, 0] != 0]
    dur = (rec[:, 1] - rec[:, 0]) / 1e3
    return {"blocks": int(rec.shape[0]), "span_us": float(rec[:, 1].max() - rec[:, 0].min()) / 1e3,
            "start_spread_us": float(rec[:, 0].max() - rec[:, 0].min()) / 1e3,
            "block_us_median": float(np.median(dur)), "block_us_max": float(dur.max()),
            "blocks_per_sm_max": int(np.bincount(rec[:, 2]).max())}


def split(torch, cs, trees, scrub, dev: str, probes, timeline: bool, tiny: bool) -> dict:
    """--split and --timeline: per tree and shape, each probe in turns with
    the tree's whole kernel; the timeline's block records."""
    from profile_smear import compile_sources

    kernels = trees["this"]
    wanted = [name for name in ("launch", "loads", "scan", "masks", "colours") if probes] + (
        ["timeline"] if timeline else [])
    built, logs = {}, {}
    for who, k in trees.items():
        csrc = os.path.join(os.path.dirname(os.path.abspath(k.__file__)), "csrc")
        sources = {f"{who}_{kn}_{p}": path for (kn, p), path in probe_sources(csrc, os.path.join(VARIANT_DIR, who)).items()
                   if p in wanted}
        for name, (lib, log) in compile_sources(kernels, sources, VARIANT_DIR).items():
            built[name] = lib
            logs[name] = cs.ptxas_info(log, "_kernel")
    entries = {"caf": ["caf"], "box_morph": ["box_morph"]}  # a second-route call's column pass stays the tree's
    for name, kernel, args in shapes(torch, cs, kernels, dev, tiny):
        for who, k in trees.items():
            whole = caller(k, kernel, args)
            row = {"shape": name, "kernel": kernel, "tree": who}
            if kernel == "box_morph":
                row["route"] = route_of(k, args)
            mine = {p: through(k, built[f"{who}_{kernel}_{p}"], whole, entries[kernel])
                    for p in wanted if f"{who}_{kernel}_{p}" in built}
            wait = wait_for(torch, cs, whole, *mine.values())
            for probe, run in mine.items():
                if probe == "timeline":
                    cs.emit({**row, "probe": probe, **timeline_stats(torch, built[f"{who}_{kernel}_{probe}"], run)})
                else:
                    cs.emit({**row, "probe": probe, "wait_ms": wait,
                             **cs.in_turns(torch, whole, scrub, wait_ms=wait, probe=run)})
    return logs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", help="a checkout of another design, run in turns with this one")
    ap.add_argument("--split", action="store_true", help="split each kernel's time by probes")
    ap.add_argument("--timeline", action="store_true", help="record each block's start and end")
    ap.add_argument("--tiny", action="store_true", help="also time 1-pixel shapes: each kernel's fixed cost")
    ap.add_argument("--warm", action="store_true", help="leave L2 warm between calls (no 128 MiB scrub)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_region: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from coherence_tpu_torch import kernels

    dev = "cuda"
    t0 = time.perf_counter()
    log = kernels.build()
    kernels.load()
    trees = {"this": kernels}
    if args.parent:
        parent = load_tree(args.parent)
        parent.build()
        parent.load()
        trees["parent"] = parent
    # 128 MiB, past the 50 MB L2: every call starts cold; with --warm 4 bytes.
    scrub = torch.empty(1 if args.warm else 32 * 2**20, dtype=torch.int32, device=dev)
    floor = cs.event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    last = {"parent": args.parent and os.path.abspath(args.parent), "launch_floor_ms": floor, "warm": args.warm}
    if args.split or args.timeline:
        last["ptxas_probes"] = split(torch, cs, trees, scrub, dev, args.split, args.timeline, args.tiny)
    else:
        compare(torch, cs, trees, scrub, dev, args.tiny)
    last["ptxas"] = {fn: cs.ptxas_info(log, fn) for fn in ("caf_", "box_morph_")}
    print(json.dumps({**last, "retaken": cs.RETAKEN[0], "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
