#!/usr/bin/env python3
"""The region kernels, caf (CF1), box_morph (MR1), tight_bounds (TB1) and
convolve_canvas (CV1), at the general renderer's shapes on one CUDA card:
against another checkout's design in turns, their time split into parts,
and each block's span on the card's global timer.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_region.py [--parent DIR] [--split] [--timeline] [--tiny] [--warm] [--kernels K,...]
    python3 profile_region.py --routes

The shapes are ``chip_smoke.region_kernels``' timed calls, recorded from
``general_filters``' whole-window render and first dragged frame
(``chip_smoke.region_inputs``): CF1 at the last frame over a white
1920 x 1080 window, the largest caf of two operands and the median caf
(``caf_timed_calls``, each caught at ``kernels.caf``'s arguments); MR1 at
each distinct bloat and erosion and at ``morph_second_route``'s synthetic
call, past one block's shared memory (``morph_timed_calls``); TB1 at the
largest and the median recorded tight_bounds mask and at
``chip_smoke.bounds_ticket_mask`` (its ticket route); CV1 at each recorded
convolve_canvas call (the frames' canvases), at config 4's 1088 x 1920
frame under mkgaussian(5) (``chip_smoke.convolve_frame``) and at
``chip_smoke.conv_second_route`` (its two passes).  Every time
is CUDA events, cold L2, each call queued behind a device-side wait of
max(1 ms, 4 x its slowest host call) (``chip_smoke.event_ms``).

The default mode times each shape's kernel through its wrapper, and the
wrapper's host side alone (``host_ms``: median and quartiles).  With
--parent DIR, DIR's package is loaded by path beside this one
(``profile_sprite.load_tree``: its library built in DIR's own ``build/``)
and each shape is timed in turns with DIR's design on the same inputs
(``chip_smoke.in_turns``: parent, this, this, parent); the two designs'
outputs must be equal.  For TB1 each tree's ``region._tight_bounds`` (the
launch and its readback to the host, synchronized) is timed on the host
clock as well (``readback_*_host_ms``), and this tree's kernel read back
by a device-to-host copy instead of its mapped host word
(``readback_this_copy_host_ms``).

--split compiles this checkout's ``region_ops.cu`` (and DIR's with
--parent) into ``build/region_variants/`` as probes that stop after one
part each (``STOPS``; wrong on purpose) and times each in turns with the
tree's own kernel: for MR1 ``launch`` (the launch alone), ``loads`` (the
source reads alone: the first design's walk with no scan, the second's
staging and bit packing) and ``scan`` (the first design's scans and
barriers over values made in registers; the second's staging and row
pass, no column pass or write); for CF1 ``launch``, ``masks`` (the mask
loads alone) and ``colours`` (every load and the composition, no
store); for TB1 ``launch``, ``walk`` (the first design's loads and
per-thread fold with no block fold, ticket or second fold) and ``fold``
(its block fold, fence, ticket and last block's fold over values made in
registers, no load); for CV1 ``launch`` (both passes' launches, each
returning at once), ``xpass`` (the x pass's launch alone, the y pass
returning at once) and ``taps`` (each pass's loads, no multiply and no
store).  --timeline runs
each whole kernel once more with every block's start and end recorded on
the global timer (``%globaltimer``) and its SM: the launch's span, the
blocks' durations and the start spread.  --tiny adds a caf of two 1 x 1
operands, a bloat of a 1 x 1 mask, the tight bounds of a 1 x 1 mask and a
radius-5 convolve of a 1 x 1 canvas (one block, a few bytes: the fixed
cost of each kernel's code path); --kernels takes only the named kernels'
shapes (caf, box_morph, tight_bounds, convolve_canvas); --warm leaves L2 warm between calls (a
4-byte scrub), so that data and code come from L2.  Last each build's
registers and static shared memory (ptxas).

--routes times TB1 alone at every distinct recorded tight_bounds mask
(shape, strides and alignment) and at ``chip_smoke.bounds_ticket_mask``:
the route ``kernels.tight_bounds_route`` picks in turns with the other
route forced (``bounds_routes``), ROUTE_ROUNDS times; the outputs must be
equal to each other and to the plain version.

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
# kernel -> (its source in csrc/, its __global__ functions: the probes of
# launch and timeline take the first the source has; CV1's second design
# runs convolve_staged_kernel at every timed shape)
KERNELS = {"caf": ("region_ops.cu", ("caf_kernel",)), "box_morph": ("region_ops.cu", ("box_morph_kernel",)),
           "tight_bounds": ("region_ops.cu", ("tight_bounds_kernel",)),
           "convolve_canvas": ("convolve.cu", ("convolve_staged_kernel", "convolve_kernel"))}


def tiny_shapes(torch, kernels, dev) -> list:
    """--tiny's shapes: a caf of two 1 x 1 operands, a radius-5 bloat of a
    1 x 1 mask, the tight bounds of a 1 x 1 mask and a radius-5 Gaussian
    convolve of a 1 x 1 canvas, each one block whose data is a few bytes:
    the fixed cost of a kernel's code path."""
    from coherence_tpu_torch.raster import convolve

    one = torch.ones((1, 1), dtype=torch.bool, device=dev)
    rgba = torch.full((1, 1, 4), 255, dtype=torch.int32, device=dev)
    plane = kernels.CafPlane(0, 0, one, rgba)
    return [("caf_tiny_1x1", "caf", ((1, 1, kernels.CAF_OPS["over"], plane, plane), {})),
            ("bloat_tiny_1x1_r5_5", "box_morph", (one, 5, 5, False)),
            ("bounds_tiny_1x1", "tight_bounds", (one,)),
            ("convolve_tiny_1x1_r5", "convolve_canvas", convolve.card_kernel(convolve.mkgaussian(5)) + (rgba, one))]


def shapes(torch, cs, kernels, dev, tiny: bool = False, only=tuple(KERNELS)) -> list:
    """[(name, kernel, args)]: kernels.caf's (args, kw) of each timed caf,
    (mask, rx, ry, erode) of each timed box_morph, (mask,) of each timed
    tight_bounds, (kind, weights, total, radius, canvas, mask) of each
    timed convolve_canvas; with `tiny` tiny_shapes' too; only the kernels
    named in `only`."""
    from coherence_tpu_torch.raster import convolve, region

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
    masks = sorted((c[0][0] for c in calls["tight_bounds"]), key=lambda m: m.numel())
    for label, mask in (("largest", masks[-1]), ("median", masks[len(masks) // 2]),
                        ("ticket", cs.bounds_ticket_mask(torch, dev))):
        out.append((f"bounds_{label}_{mask.shape[0]}x{mask.shape[1]}", "tight_bounds", (mask,)))
    frame, _ = cs.convolve_frame(torch, dev)
    whole = torch.ones(frame.shape[:2], dtype=torch.bool, device=dev)
    config4 = convolve.card_kernel(convolve.mkgaussian(cs.BLUR_RADIUS)) + (frame, whole)
    for args, _ in calls["convolve_canvas"] + [(config4, {})]:
        H, W = args[4].shape[:2]
        out.append((f"convolve_{args[0]}_{H}x{W}_r{args[3]}", "convolve_canvas", args))
    second = cs.conv_second_route(torch, dev, calls["convolve_canvas"])
    out.append((f"convolve_second_{second[4].shape[0]}x{second[4].shape[1]}_r{second[3]}", "convolve_canvas", second))
    return [row for row in out if row[1] in only]


def caller(k, kernel: str, args):
    """A call of tree `k`'s wrapper on `args` (caf's planes as its own
    CafPlane)."""
    if kernel == "box_morph":
        mask, rx, ry, erode = args
        return lambda: k.box_morph(mask, rx, ry, erode=erode)
    if kernel == "tight_bounds":
        return lambda: k.tight_bounds(*args)
    if kernel == "convolve_canvas":
        return lambda: k.convolve_canvas(*args)
    a, kw = args
    a = tuple(k.CafPlane(*x) if isinstance(x, tuple) else x for x in a)
    return lambda: k.caf(*a, **kw)


def route_of(k, kernel: str, args) -> object:
    """The route of tree `k`'s `kernel` at `args` where the tree has more
    than one (MR1's box_morph_route, TB1's tight_bounds_route, CV1's
    convolve_route), else None."""
    if kernel == "box_morph":
        mask, rx, ry, erode = args
        return k.box_morph_route(*mask.shape, rx, ry, erode)._asdict() if hasattr(k, "box_morph_route") else None
    if kernel == "tight_bounds" and hasattr(k, "tight_bounds_route"):
        return k.tight_bounds_route(*args[0].shape, *args[0].stride())._asdict()
    if kernel == "convolve_canvas" and hasattr(k, "convolve_route"):
        kind, _, _, radius, canvas, _ = args
        return k.convolve_route(kind, *canvas.shape[:2], radius)._asdict()
    return None


def region_of(k):
    """Tree `k`'s raster/region module (k is its kernels module)."""
    import importlib

    return importlib.import_module(k.__name__.rsplit(".", 1)[0] + ".raster.region")


def same_output(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def compare(torch, cs, trees, scrub, dev: str, tiny: bool, only) -> None:
    """The default mode: per shape each tree's kernel, in turns."""
    kernels = trees["this"]
    for name, kernel, args in shapes(torch, cs, kernels, dev, tiny, only):
        calls = {who: caller(k, kernel, args) for who, k in trees.items()}
        row = {"shape": name, "kernel": kernel}
        if kernel == "caf":
            row["this_one_trip"] = kernels.caf_one_trip(*args[0][:2])
        else:
            row.update({f"{who}_route": route_of(k, kernel, args) for who, k in trees.items()})
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
        if kernel == "tight_bounds":
            readbacks = {who: (lambda r=region_of(k), m=args[0]: r._tight_bounds(m)) for who, k in trees.items()}
            if hasattr(kernels, "bounds_word"):  # this tree's kernel read back by a copy, not its mapped word
                readbacks["this_copy"] = lambda m=args[0]: tuple(kernels.tight_bounds(m).tolist())
            values = {who: c() for who, c in readbacks.items()}
            row["bounds"] = values["this"]
            cs.require(len(set(values.values())) == 1, f"profile_region: {name}'s readbacks differ: {values}")
            row.update({f"readback_{key}": v for key, v in host_ms(torch, readbacks).items()})
        cs.emit({**row, "wait_ms": wait, **got, **host_ms(torch, calls)})


ROUTE_ROUNDS = 3  # --routes: in_turns rounds a mask


def bounds_routes(k, mask) -> dict:
    """--routes: {"picked": the route tree `k`'s tight_bounds_route picks at
    `mask`, "other": the other route forced}: one block over every row
    where it picks the ticket; where it picks one block, the ticket over
    the fewest blocks past one (their rows a multiple of the warps; one
    block for a mask of at most TIGHT_BOUNDS_WARPS rows)."""
    h, w = mask.shape
    picked = k.tight_bounds_route(h, w, *mask.stride())
    if picked.route != k.BOUNDS_ONE:
        return {"picked": picked, "other": picked._replace(route=k.BOUNDS_ONE, rows=h, blocks=1)}
    warps = k.TIGHT_BOUNDS_WARPS
    rows = warps * max(1, -(-h // (2 * warps)))
    return {"picked": picked, "other": picked._replace(route=k.BOUNDS_TICKET, rows=rows, blocks=-(-h // rows))}


def forced_bounds(k, mask, route):
    """A call of tree `k`'s kernels.tight_bounds on `mask` with its route
    function giving `route`."""
    def run():
        saved = k.tight_bounds_route
        k.tight_bounds_route = lambda h, w, sy, sx: route
        try:
            return k.tight_bounds(mask)
        finally:
            k.tight_bounds_route = saved
    return run


def routes(torch, cs, k, scrub, dev: str) -> None:
    """--routes: per mask the picked route in turns with the other."""
    from coherence_tpu_torch.raster import region

    calls, _ = cs.region_inputs(torch, dev)
    distinct = {}
    for (mask, *_), _ in calls["tight_bounds"]:
        distinct.setdefault((tuple(mask.shape), mask.stride(), mask.data_ptr() % 16), mask)
    for mask in sorted(distinct.values(), key=lambda m: m.numel()) + [cs.bounds_ticket_mask(torch, dev)]:
        named = bounds_routes(k, mask)
        run = {name: forced_bounds(k, mask, r) for name, r in named.items()}
        outs = {name: tuple(c().tolist()) for name, c in run.items()}
        want = region._tight_bounds_torch(mask)
        cs.require(set(outs.values()) == {want}, f"profile_region: {tuple(mask.shape)}'s routes differ: {outs}, {want}")
        wait = wait_for(torch, cs, *run.values())
        rounds = [cs.in_turns(torch, run["picked"], scrub, wait_ms=wait, other=run["other"])
                  for _ in range(ROUTE_ROUNDS)]
        cs.emit({"mask": list(mask.shape), "strides": list(mask.stride()), "align16": mask.data_ptr() % 16,
                 **{f"{name}_route": r._asdict() for name, r in named.items()}, "bounds": want, "wait_ms": wait,
                 "picked_ms": [r["ms"] for r in rounds], "other_ms": [r["other_ms"] for r in rounds],
                 "readings": [r["readings"] for r in rounds]})


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
# TB1's and CV1's first designs (PR 22).
TB1_WALKED = "  mine = block_fold(mine, warps);\n  unsigned* ticket"
# TB1's second design: `walk` the one-block route's walk with no block
# fold (the other routes unchanged), `fold` every route's folds over values
# made in registers (the walk returns at once).
TB1_ONE = ("    const Bounds mine = block_fold(walk<kLayout>(p), warps);\n"
           "    if (threadIdx.x == 0) write_bounds(p.out, mine);\n")
TB1_WALK = "  // The edge granules' bytes, a lane each"
STOPS[("tight_bounds", "walk")] = [
    [(TB1_ONE, "    const Bounds mine = walk<kLayout>(p);\n"
               "    if (mine.x0 == -7) p.out[0] = mine.y1 ^ mine.x1 ^ mine.y0;\n")],
    [(TB1_WALKED, "  if (mine.x0 == -7) out[0] = mine.y1 ^ mine.x1 ^ mine.y0;\n  return;\n" + TB1_WALKED)],
]
STOPS[("tight_bounds", "fold")] = [
    [(TB1_WALK, "  if (p.h > 0) return {static_cast<int>(threadIdx.x) % p.w, 0, static_cast<int>(threadIdx.x) % p.w,\n"
                "                      static_cast<int>(blockIdx.x) % p.h};\n" + TB1_WALK)],
]
STOPS[("tight_bounds", "fold")] += [
    [("  for (long long i = static_cast<long long>(blockIdx.x) * kTbThreads + threadIdx.x; i < n;",
      "  if (n > 0) mine = {static_cast<int>(threadIdx.x) % w, static_cast<int>(blockIdx.x) % h,\n"
      "                     static_cast<int>(threadIdx.x) % w, static_cast<int>(blockIdx.x) % h};\n"
      "  for (long long i = n; i < n;")],
]
CV1_ENTRY = "__global__ void __launch_bounds__(kThreads) convolve_kernel(Params p) {\n"
# CV1's second design (the staged route): `stage` stops after the staging,
# `xpass` after the x pass (no y pass, no store); each listed first, since
# the first design's recipes fit its second route too.
CV1_STAGED = "  __syncthreads();\n\n  // 2. The x pass"
CV1_XDONE = "  __syncthreads();\n\n  // 3. The y pass"
CV1_KEEP = "  if (p.radius < 0) p.dst[threadIdx.x] = cs[threadIdx.x];\n  return;\n"
STOPS[("convolve_canvas", "stage")] = [
    [(CV1_STAGED, CV1_STAGED.replace("  // 2.", CV1_KEEP + "  // 2."))],
]
STOPS[("convolve_canvas", "xpass")] = [
    [(CV1_XDONE, CV1_XDONE.replace("  // 3.", CV1_KEEP + "  // 3."))],
    [(CV1_ENTRY, CV1_ENTRY + "  if (p.mode == kPassY) return;\n")],
]
STOPS[("convolve_canvas", "taps")] = [
    [("  acc[0] += w * static_cast<uint32_t>(v.x);\n",
      "  acc[0] ^= static_cast<uint32_t>(v.x ^ v.y ^ v.z ^ v.w);\n  return;\n"),
     ("      p.dst[i] = p.src[i];\n", "      if (p.src[i].x == 0x7fffffff) p.dst[i].x = 1;\n"),
     ("    p.dst[i] = make_int4(rr, gg, floordiv(acc[2], p), a);\n",
      "    if (rr + gg + a == 0x7ffffff1) p.dst[i].x = acc[2];\n")],
]

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


def probe_sources(csrc: str, directory: str, only=tuple(KERNELS)) -> dict:
    """(kernel, probe) -> .cu path: probes of the source in `csrc` of each
    kernel named in `only` (every entry point unchanged), each written into
    a directory of its own; a probe none of whose recipes fits the source
    is left out."""
    sources = {}
    for name in {KERNELS[k][0] for k in only}:
        with open(os.path.join(csrc, name)) as f:
            sources[name] = f.read()
    edits = {}
    for kernel in only:
        file, fns = KERNELS[kernel]
        src = sources[file]
        head, body, tail = kernel_body(src, next(fn for fn in fns if re.search(r"\b%s\(" % fn, src)))
        edits[kernel, "launch"] = head + "  return;\n" + body + tail
        timed = body.replace("return;", TIMELINE_END)
        edits[kernel, "timeline"] = (head.replace("namespace {\n", PROBE_HEAD + "namespace {\n", 1) + TIMELINE_START
                                     + timed + "  " + TIMELINE_END + "\n" + tail + PROBE_TAIL)
    for (kernel, probe), recipes in STOPS.items():
        if kernel not in only:
            continue
        src = sources[KERNELS[kernel][0]]
        for recipe in recipes:
            if all(old in src for old, _ in recipe):
                text = src
                for old, new in recipe:
                    text = text.replace(old, new, 1)
                edits[kernel, probe] = text
                break
        else:
            continue  # this design has no such probe
    out = {}
    for (kernel, probe), text in edits.items():
        d = os.path.join(directory, f"{kernel}_{probe}")
        os.makedirs(d, exist_ok=True)
        out[kernel, probe] = os.path.join(d, KERNELS[kernel][0])
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
    if len(rec) == 0:  # the probed kernel did not run: the shape takes another route
        return {"blocks": 0}
    dur = (rec[:, 1] - rec[:, 0]) / 1e3
    return {"blocks": int(rec.shape[0]), "span_us": float(rec[:, 1].max() - rec[:, 0].min()) / 1e3,
            "start_spread_us": float(rec[:, 0].max() - rec[:, 0].min()) / 1e3,
            "block_us_median": float(np.median(dur)), "block_us_max": float(dur.max()),
            "blocks_per_sm_max": int(np.bincount(rec[:, 2]).max())}


def split(torch, cs, trees, scrub, dev: str, probes, timeline: bool, tiny: bool, only) -> dict:
    """--split and --timeline: per tree and shape, each probe in turns with
    the tree's whole kernel; the timeline's block records."""
    from profile_smear import compile_sources

    kernels = trees["this"]
    wanted = [name for name in ("launch", "loads", "scan", "masks", "colours", "walk", "fold", "stage", "xpass", "taps")
              if probes] + (["timeline"] if timeline else [])
    built, logs = {}, {}
    for who, k in trees.items():
        csrc = os.path.join(os.path.dirname(os.path.abspath(k.__file__)), "csrc")
        probes_of = probe_sources(csrc, os.path.join(VARIANT_DIR, who), only)
        sources = {f"{who}_{kn}_{p}": path for (kn, p), path in probes_of.items() if p in wanted}
        for name, (lib, log) in compile_sources(kernels, sources, VARIANT_DIR).items():
            built[name] = lib
            logs[name] = cs.ptxas_info(log, "_kernel")
    # a second-route MR1 call's column pass stays the tree's
    entries = {"caf": ["caf"], "box_morph": ["box_morph"], "tight_bounds": ["tight_bounds"],
               "convolve_canvas": ["convolve_canvas"]}
    for name, kernel, args in shapes(torch, cs, kernels, dev, tiny, only):
        for who, k in trees.items():
            whole = caller(k, kernel, args)
            row = {"shape": name, "kernel": kernel, "tree": who}
            if kernel != "caf":
                row["route"] = route_of(k, kernel, args)
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
    ap.add_argument("--kernels", default=",".join(KERNELS), help="the kernels to take, comma-separated (default all)")
    ap.add_argument("--routes", action="store_true", help="TB1's picked route in turns with its other route")
    args = ap.parse_args()
    only = tuple(args.kernels.split(","))
    if not set(only) <= set(KERNELS):
        ap.error(f"--kernels: no kernel {sorted(set(only) - set(KERNELS))}")
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
    if args.routes:
        routes(torch, cs, kernels, scrub, dev)
    elif args.split or args.timeline:
        last["ptxas_probes"] = split(torch, cs, trees, scrub, dev, args.split, args.timeline, args.tiny, only)
    else:
        compare(torch, cs, trees, scrub, dev, args.tiny, only)
    last["ptxas"] = {fn: cs.ptxas_info(log, fn) for fn in ("caf_", "box_morph_", "tight_bounds_", "convolve_")}
    print(json.dumps({**last, "retaken": cs.RETAKEN[0], "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
