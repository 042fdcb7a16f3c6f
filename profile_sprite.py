#!/usr/bin/env python3
"""sprite_raster (SR1) at the general renderer's shapes on one CUDA card:
its time split into parts, against another checkout's design in turns, and
the renders it serves.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_sprite.py [--parent DIR]
    python3 profile_sprite.py --split [--parent DIR]
    python3 profile_sprite.py --e2e [--tree DIR]

The shapes are ``chip_smoke.sprite_inputs``' (``general_lion``'s rebuild:
the lion's 130 batched members in one launch, ``lion_members``, and the
mattes of its two scalar members in opacity mode), and, where this
checkout's ``chip_smoke`` has it, the 131,071 x 2 matte of
``chip_smoke.h61_matte``.  Every time is CUDA events, cold L2, each call
queued behind a device-side wait of max(1 ms, 4 x its slowest host call)
(``chip_smoke.event_ms``, H42).

The default mode times, per shape, the kernel alone on lists staged
beforehand, the staged copy alone, and the wrapper's whole host side (the
lists, the staged copy and the launch, not waited for; host clock), and
counts the units and the spans a launch reads (each unit's ranges, each
span once a unit).  With --parent DIR, DIR's package is loaded by path
beside this one (``load_tree``: its library and its native host library
built in DIR's own ``build/``) and each number is taken in turns with
DIR's design on the same inputs (``chip_smoke.in_turns``: parent, this,
this, parent; the host side in rounds of the same order); the two designs'
outputs must be equal.

--split splits the kernel's time: this checkout's ``sprite_raster.cu`` (and
DIR's with --parent) is compiled alone into ``build/sprite_variants/`` as
probes that stop after one part each (``probe_sources``; wrong on purpose):
``launch`` (the launch alone), ``rows1x`` (the 1x families' span reads,
bins and rows), ``fringe`` (and the fringe list, or opacity mode's list of
pixels), ``trows`` (and the AA family's reads, bins and t-row words),
``count`` (and the footprint counts: everything but the write pass); each
in turns with the tree's own kernel.  ``timeline`` runs the whole kernel
and records each block's start and end on the card's global timer, its SM
cycles and its SM, and names the longest block (H60); ``phases`` runs it
too and records each block's SM cycles by part (``PHASES``: each
build_rows' count pass, scan, binning and row builders, the fringe, the
classification, the counts, the write pass), the longest block's parts
beside the sums over blocks.  Last the ptxas lines of each build.

--e2e times the renders SR1 serves, for the checkout at --tree (run a
parent checkout and this one as separate processes in turns: parent,
this, this, parent): ``general_lion``'s rebuild on the batched route and on
the per-member fold route (host clock after a synchronize, and CUDA
events), and ``general_filters``' incremental frames (frames 1-9 of 10,
median and p95).

Each mode prints JSON lines and, last, one with the launch floor (an empty
kernel timed alike) and the card's name and power limit.
"""

import argparse
import ctypes
import glob
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

VARIANT_DIR = os.path.join("build", "sprite_variants")
PROBE_BLOCKS = 1 << 17  # the timeline probe's records (a launch of more blocks records its first ones)


def load_tree(directory: str):
    """DIR's ``coherence_tpu_torch`` loaded by path as the package
    ``coherence_tpu_torch_parent`` (the port imports itself only
    relatively, so every module of it comes from DIR, and its libraries
    build under DIR's ``build/``).  Returns its ``kernels`` module."""
    name = "coherence_tpu_torch_parent"
    if name not in sys.modules:
        root = os.path.join(os.path.abspath(directory), "coherence_tpu_torch")
        spec = importlib.util.spec_from_file_location(name, os.path.join(root, "__init__.py"),
                                                      submodule_search_locations=[root])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".kernels")


def shapes(torch, cs, dev) -> dict:
    """name -> ("group", (boxes, fills, cov, cross, aa)) or ("opacity",
    (box, scaled)): the rebuild's SR1 calls, and the H61 matte."""
    inputs = cs.sprite_inputs(torch, dev)
    ms = [m for members in inputs["groups"].values() for m in members]
    out = {"lion_members": ("group", ([(m.x0, m.y0, m.w, m.h) for m in ms], [m.fill for m in ms],
                                      [m.cov for m in ms], [m.cross for m in ms], [m.aa for m in ms]))}
    for box, scaled in inputs["mattes"]:
        out[f"matte_{box[2] - box[0] + 1}x{box[3] - box[1] + 1}"] = ("opacity", (box, scaled))
    if hasattr(cs, "h61_matte"):
        out["matte_h61"] = ("opacity", cs.h61_matte())
    return out


def make_lists(kernels, mode: str, args):
    return kernels.sprite_raster_lists(*args) if mode == "group" else kernels.sprite_opacity_lists(*args)


def wrapper(kernels, mode: str, args, dev: str):
    """The call the program makes: the host lists, the staged copy and the
    launch (fastframe._sprite_raster_members, aa.coverage_opacity)."""
    if mode == "opacity":
        return kernels.sprite_raster_opacity(*args, dev)
    lists = kernels.sprite_raster_lists(*args)
    return kernels.sprite_raster(lists, kernels.stage_sprite_lists(lists, dev))


def ptxas_lines(log: str, function: str) -> list:
    """ptxas's register and spill lines of the entry functions whose names
    hold `function`, from nvcc's output `log`."""
    out, current = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            current = ln.split()[-1].strip("'") if "properties" in ln else ln.split("'")[1]
        elif ("registers" in ln or "spill" in ln) and function in current:
            out.append(ln.strip())
    return out


def unit_span_reads(lists) -> int:
    """The spans a launch over `lists` reads, each once a unit: a unit's
    band ranges where the lists have them (``bands``), else its member's
    whole lists (the first design's ``offsets``)."""
    import numpy as np

    units = lists.units.astype(np.int64)
    if hasattr(lists, "bands"):
        b = lists.bands[units[:, 3]].astype(np.int64)
        return int((b[:, 1] - b[:, 0] + b[:, 3] - b[:, 2] + b[:, 5] - b[:, 4]).sum())
    off = lists.offsets.astype(np.int64)
    per = (off[:, 1:] - off[:, :-1]).sum(0)
    return int(per[units[:, 0]].sum())


def same_output(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def host_ms(call, reps: int = 25) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def wait_for(torch, cs, *calls) -> float:
    """max(ANIMATED_WAIT_MS, 4 x the slowest host call of any of `calls`),
    each called once first (a probe library's first launch loads it)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    slowest = max(max(host_ms(c, 10)) for c in calls)
    torch.cuda.synchronize()
    return max(cs.ANIMATED_WAIT_MS, 4 * slowest)


def quartiles(values) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": q2, "quartiles": [q1, q3]}


def compare(torch, cs, kernels, parent, scrub, dev: str, rounds: int = 30) -> None:
    """The default mode: per shape this tree's SR1 (and DIR's in turns)."""
    trees = {"this": kernels, **({"parent": parent} if parent is not None else {})}
    for name, (mode, args) in shapes(torch, cs, dev).items():
        row = {"shape": name}
        calls = {}
        for who, k in trees.items():
            try:
                lists = make_lists(k, mode, args)
            except ValueError as e:  # the first design refuses the H61 matte
                row[f"{who}_refused"] = str(e)
                continue
            staged = k.stage_sprite_lists(lists, dev)
            calls[who] = {
                "kernel": lambda k=k, lists=lists, staged=staged: k.sprite_raster(lists, staged),
                "copy": lambda k=k, lists=lists: k.stage_sprite_lists(lists, dev),
                "wrapper": lambda k=k: wrapper(k, mode, args, dev),
            }
            row[f"{who}_units"], row[f"{who}_spans"] = len(lists.units), len(lists.spans)
            row[f"{who}_unit_span_reads"] = unit_span_reads(lists)
        if "this" not in calls:
            cs.emit(row)
            continue
        outs = {who: c["kernel"]() for who, c in calls.items()}
        torch.cuda.synchronize()
        if "parent" in outs:
            row["equal_parent"] = same_output(torch, outs["this"], outs["parent"])
            cs.require(row["equal_parent"], f"profile_sprite: {name} differs from the parent's design")
        others = {who: c for who, c in calls.items() if who != "this"}
        for part in ("kernel", "copy"):
            wait = wait_for(torch, cs, *(c[part] for c in calls.values()))
            got = cs.in_turns(torch, calls["this"][part], scrub, wait_ms=wait,
                              **{who: c[part] for who, c in others.items()})
            row[f"{part}_wait_ms"] = wait
            row[f"{part}_ms"] = got["ms"]
            row.update({f"{part}_{k}": v for k, v in got.items() if k != "ms"})
        spent = {who: [] for who in calls}
        for c in calls.values():
            c["wrapper"]()
        torch.cuda.synchronize()
        order = [*others, "this", "this", *reversed(others)]
        for _ in range(rounds):
            for who in order:
                spent[who].extend(host_ms(calls[who]["wrapper"], 1))
            torch.cuda.synchronize()
        row.update({f"{who}_host_ms": quartiles(v) for who, v in spent.items()})
        cs.emit(row)


# Probe stops: (name, the source lines before the first of which the block
# stops; the second design's first, the first design's second).  Each stop
# keeps its shared memory alive (probe_keep) and returns.
STOPS = (
    ("launch", ("  const int4 unit = p.units[blockIdx.x];\n",)),
    ("rows1x", ("    fringe_of(cov, ny, s.need, s.fringe, &s.listed);\n",)),
    ("fringe", ("  const int listed = s.listed;\n",)),
    ("trows", ("    if (p.opacity) classify(", "    footprint_opacity(s.builder, s.tbits, s.fringe, ")),
    ("count", ("  // The unit's pixels, row by row of the member's planes.\n",)),
)
PROBE_HEAD = """
// probe: what a stop or the timeline needs.
__device__ long long probe_timeline[%(blocks)d][4];
__device__ __forceinline__ void probe_keep(const Params& p, const Smem& s) {
  __syncthreads();
  if (threadIdx.x == 0 && p.n < 0) p.out[0] = s.masks[0][0] + s.tbits[0][0] + s.opac[0][0] + s.listed;
}
__device__ __forceinline__ long long probe_now() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_end(long long t0, long long c0) {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < %(blocks)d) {
    const long long t1 = probe_now(), c1 = clock64();
    unsigned smid;
    asm("mov.u32 %%0, %%%%smid;" : "=r"(smid));
    long long* o = probe_timeline[blockIdx.x];
    o[0] = t0, o[1] = t1, o[2] = c1 - c0, o[3] = smid;
  }
}
""" % {"blocks": PROBE_BLOCKS}
PROBE_TAIL = """
extern "C" int probe_timeline_read(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, probe_timeline, 32L * n));
}
"""
KERNEL_AT = "__global__ void __launch_bounds__(kThreads, 2) sprite_raster_kernel("
BODY_AT = "  Smem& s = *reinterpret_cast<Smem*>(smem4);\n"


# The phases probe: each block's SM cycles by part, accumulated at the
# barriers that end each part (thread 0's clock64), parts 0-3 of the 1x
# rows' build_rows (its count pass with the unit's set-up, the scan, the
# binning passes, the row builders; the second design's one-pass union_rows
# counts as the builders, with what precedes it), 4 fringe_of, 5-8 the AA
# family's alike (the nibble table in the first part that runs), 9 opacity
# mode's classification, 10 the footprint counts, 11 the write pass.
PHASES = ("rows1x_count", "rows1x_scan", "rows1x_bins", "rows1x_build", "fringe", "trows_count", "trows_scan",
          "trows_bins", "trows_build", "classify", "count", "write")
PHASE_HEAD = """
// probe: each block's cycles by part.
__shared__ long long probe_acc[16];
__shared__ long long probe_last;
__shared__ int probe_base;
__device__ __forceinline__ void probe_mark_abs(int part) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    probe_acc[part] += t - probe_last;
    probe_last = t;
  }
}
#define PROBE_MARK(k) probe_mark_abs(probe_base + (k))
__device__ long long probe_phases[%(blocks)d][12];
""" % {"blocks": PROBE_BLOCKS}
PHASE_TAIL = """
extern "C" int probe_phases_read(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, probe_phases, 96L * n));
}
"""
# (anchor in span_rows.cuh, the mark after it) of both designs' build_rows.
ROW_MARKS = (
    ("    if (any(need(t))) atomicAdd(&s.fill[t], 1);\n  });\n  __syncthreads();\n", "  PROBE_MARK(0);\n"),
    ("exclusive_scan(s.fill, s.first, nt);\n  __syncthreads();\n", "  PROBE_MARK(1);\n"),
    ("        s.b.bin.stop[at] = static_cast<uint16_t>(c >> 16);\n      }\n    });\n    __syncthreads();\n",
     "    PROBE_MARK(2);\n"),
    ("      one_row(s, src, lo, hi, lo2, hi2, r0, nr, ra, need, out + ra * words, words);\n", "      PROBE_MARK(3);\n"),
)
ROW_MARK_BEFORE = ("    ra = rb;\n", "    PROBE_MARK(3);\n")


def phase_sources(src: str, header: str):
    """The phases probe of sprite_raster.cu's text `src` and span_rows.cuh's
    `header`: (sprite_raster.cu, span_rows.cuh)."""
    for at, mark in ROW_MARKS:
        if at not in header:
            raise RuntimeError(f"profile_sprite: the phases probe found no {at.strip()!r} in span_rows.cuh")
        header = header.replace(at, at + mark, 1)
    at, mark = ROW_MARK_BEFORE
    header = header.replace(at, mark + at, 1)
    include = '#include "span_rows.cuh"\n'
    src = src.replace(include, PHASE_HEAD + include, 1) + PHASE_TAIL
    marks = (
        (BODY_AT, BODY_AT + "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 16; ++i) probe_acc[i] = 0;\n"
                            "    probe_last = clock64(), probe_base = 0;\n  }\n"),
        ("    fringe_of(cov, ny, s.need, s.fringe, &s.listed);\n",
         "    fringe_of(cov, ny, s.need, s.fringe, &s.listed);\n    probe_mark_abs(4);\n"),
        ("    nibble_table(s.builder);\n", "    if (threadIdx.x == 0) probe_base = 5;\n    nibble_table(s.builder);\n"),
        ("    footprint_opacity(s.builder, s.tbits, s.fringe, ", "    __syncthreads();\n    probe_mark_abs(9);\n"
                                                            "    footprint_opacity(s.builder, s.tbits, s.fringe, "),
        ("  // The unit's pixels, row by row of the member's planes.\n",
         "  probe_mark_abs(10);\n  // The unit's pixels, row by row of the member's planes.\n"),
    )
    for at, new in marks:
        if at not in src:
            raise RuntimeError(f"profile_sprite: the phases probe found no {at.strip()!r}")
        src = src.replace(at, new, 1)
    # The second design builds its rows in one pass (union_rows): its time is the rows' build.
    src = src.replace("&s.reversed);\n", "&s.reversed);\n    PROBE_MARK(3);\n")
    end = ("  {  // probe: the write pass, then the block's parts\n    __syncthreads();\n    probe_mark_abs(11);\n"
           "    __syncthreads();\n    if (threadIdx.x < 12 && blockIdx.x < %d) probe_phases[blockIdx.x][threadIdx.x] = probe_acc[threadIdx.x];\n"
           "  }\n" % PROBE_BLOCKS)
    head, kernel_at = src.split(KERNEL_AT, 1)
    body_end = kernel_at.index("\n}\n")
    body = kernel_at[:body_end].replace("    return;\n", end + "    return;\n")
    return head + KERNEL_AT + body + "\n" + end.rstrip("\n") + kernel_at[body_end:], header


def probe_sources(csrc: str, directory: str) -> dict:
    """name -> .cu path: probes of `csrc`/sprite_raster.cu (the entry point
    unchanged), each written with the csrc headers into a directory of its
    own under `directory`."""
    with open(os.path.join(csrc, "sprite_raster.cu")) as f:
        src = f.read()
    for at in (KERNEL_AT, BODY_AT):
        if at not in src:
            raise RuntimeError(f"profile_sprite: {at.strip()!r} is not in {csrc}/sprite_raster.cu")
    src = src.replace(KERNEL_AT, PROBE_HEAD + KERNEL_AT, 1) + PROBE_TAIL
    edits = {}
    for name, anchors in STOPS:
        at = next((a for a in anchors if a in src), None)
        if at is None:
            raise RuntimeError(f"profile_sprite: the {name} stop found none of {anchors}")
        edits[name] = src.replace(at, "  {  // probe: stop\n    probe_keep(p, s);\n    return;\n  }\n" + at, 1)
    timeline = src.replace(BODY_AT, BODY_AT + "  const long long probe_t0 = probe_now(), probe_c0 = clock64();\n", 1)
    # Every return of the kernel records the block's end first.
    head, kernel_at = timeline.split(KERNEL_AT, 1)
    body_end = kernel_at.index("\n}\n")
    body = kernel_at[:body_end].replace("    return;\n", "    probe_end(probe_t0, probe_c0);\n    return;\n")
    edits["timeline"] = head + KERNEL_AT + body + "\n  probe_end(probe_t0, probe_c0);" + kernel_at[body_end:]
    with open(os.path.join(csrc, "span_rows.cuh")) as f:
        headers = {"phases": None}
        edits["phases"], headers["phases"] = phase_sources(src, f.read())
    out = {}
    for name, text in edits.items():
        d = os.path.join(directory, name)
        os.makedirs(d, exist_ok=True)
        for h in glob.glob(os.path.join(csrc, "*.cuh")):
            shutil.copy(h, d)
        if headers.get(name):
            with open(os.path.join(d, "span_rows.cuh"), "w") as f:
                f.write(headers[name])
        out[name] = os.path.join(d, "sprite_raster.cu")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def through(kernels, lib: str):
    """A call of kernels.sprite_raster whose launch goes to the entry point
    of the built probe `lib` (same arguments as the tree's own)."""
    fn = ctypes.CDLL(os.path.abspath(lib)).sprite_raster
    fn.argtypes = kernels._ENTRY_POINTS["sprite_raster"]
    fn.restype = ctypes.c_int
    kernels.load()

    def call(lists, staged):
        saved = kernels._fns
        kernels._fns = {**saved, "sprite_raster": fn}
        try:
            return kernels.sprite_raster(lists, staged)
        finally:
            kernels._fns = saved
    return call


def timeline_stats(torch, lib: str, lists) -> dict:
    """The timeline probe's records of its last launch -> the launch's
    span, the blocks' durations, the SM clock and the longest block's unit
    with the spans it reads."""
    import numpy as np

    n = min(len(lists.units), PROBE_BLOCKS)
    rec = np.zeros((n, 4), np.int64)
    rc = ctypes.CDLL(os.path.abspath(lib)).probe_timeline_read(ctypes.c_void_p(rec.ctypes.data), n)
    if rc != 0:
        raise RuntimeError(f"probe_timeline_read: CUDA error {rc}")
    t = torch.from_numpy(rec).double()
    dur = t[:, 1] - t[:, 0]
    slowest = int(dur.argmax())
    one = lists._replace(units=lists.units[slowest : slowest + 1])
    return {"span_us": float(t[:, 1].max() - t[:, 0].min()) / 1e3,
            "start_spread_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3,
            "block_us_median": float(dur.median()) / 1e3, "block_us_max": float(dur.max()) / 1e3,
            "ghz": float((t[:, 2] / dur.clamp(min=1)).median()),
            "blocks_per_sm_max": int(torch.bincount(t[:, 3].long()).max()),
            "slowest_block": slowest, "slowest_unit": [int(v) for v in lists.units[slowest]],
            "slowest_unit_span_reads": unit_span_reads(one)}


def phase_stats(lib: str, lists) -> dict:
    """The phases probe's records of its last launch -> per part the
    blocks' summed and median cycles, and the longest block's parts."""
    import numpy as np

    n = min(len(lists.units), PROBE_BLOCKS)
    rec = np.zeros((n, 12), np.int64)
    rc = ctypes.CDLL(os.path.abspath(lib)).probe_phases_read(ctypes.c_void_p(rec.ctypes.data), n)
    if rc != 0:
        raise RuntimeError(f"probe_phases_read: CUDA error {rc}")
    slowest = int(rec.sum(1).argmax())
    return {"phase_cycles_sum": dict(zip(PHASES, rec.sum(0).tolist())),
            "phase_cycles_median": dict(zip(PHASES, np.median(rec, 0).tolist())),
            "slowest_block_phases": dict(zip(PHASES, rec[slowest].tolist())),
            "slowest_block_cycles": int(rec[slowest].sum()), "slowest_phase_unit": [int(v) for v in lists.units[slowest]]}


def split(torch, cs, kernels, parent, scrub, dev: str) -> dict:
    """--split: per tree and shape, each probe in turns with the tree's kernel."""
    from profile_smear import compile_sources

    trees = {"this": kernels, **({"parent": parent} if parent is not None else {})}
    built = {}
    for who, k in trees.items():
        csrc = os.path.join(os.path.dirname(os.path.abspath(k.__file__)), "csrc")
        sources = probe_sources(csrc, os.path.join(VARIANT_DIR, who))
        built[who] = compile_sources(kernels, {f"{who}_{name}": path for name, path in sources.items()}, VARIANT_DIR)
    for name, (mode, args) in shapes(torch, cs, dev).items():
        for who, k in trees.items():
            try:
                lists = make_lists(k, mode, args)
            except ValueError:
                continue
            staged = k.stage_sprite_lists(lists, dev)
            whole = lambda k=k, lists=lists, staged=staged: k.sprite_raster(lists, staged)  # noqa: E731
            row = {"shape": name, "tree": who, "units": len(lists.units), "spans": len(lists.spans),
                   "unit_span_reads": unit_span_reads(lists), "blocks_per_sm": k.sprite_raster_blocks_per_sm()}
            probes = {p[len(who) + 1:]: (lib, through(k, lib)) for p, (lib, _) in built[who].items()}
            wait = wait_for(torch, cs, whole, *(lambda c=c: c(lists, staged) for _, c in probes.values()))
            row["wait_ms"] = wait
            for probe, (lib, call) in probes.items():
                extra = {}
                if probe in ("timeline", "phases"):
                    call(lists, staged)
                    torch.cuda.synchronize()
                    extra = (timeline_stats(torch, lib, lists) if probe == "timeline" else phase_stats(lib, lists))
                turns = cs.in_turns(torch, whole, scrub, wait_ms=wait, probe=lambda c=call: c(lists, staged))
                cs.emit({**row, "probe": probe, **extra, **turns})
            copy = lambda k=k, lists=lists: k.stage_sprite_lists(lists, dev)  # noqa: E731
            cs.emit({**row, "copy_ms": cs.event_ms(torch, copy, scrub, wait_ms=wait_for(torch, cs, copy), queued=True)})
    return {who: ptxas_lines(log, "sprite_raster") for b in built.values() for who, (_, log) in b.items()}


def e2e(torch, cs, kernels, dev: str, rebuilds: int = 7, folds: int = 5) -> None:
    """--e2e: general_lion's rebuild on both routes and general_filters'
    incremental frames, for the checkout at --tree."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import flags

    cs.fresh_cache()
    obj = cs.fitted_lion()
    shape = region.shape_of_box(cs.WINDOW, dev)
    render = lambda: R.render_simple_scene([obj], shape, dev)  # noqa: E731
    render()
    rows = {}
    for route, n in (("batched", rebuilds), ("fold", folds)):
        flags.set_flag("batch_group_raster", route == "batched")
        try:
            stats = []
            for _ in range(n):
                cache.clear()
                before = kernels.launches["sprite_raster"]
                _, st = cs.measured(torch, dev, render)
                st["sprite_raster"] = kernels.launches["sprite_raster"] - before
                stats.append(st)
        finally:
            flags.set_flag("batch_group_raster", True)
        rows[route] = {"host_ms": [s["host_ms"] for s in stats], "event_ms": [s["event_ms"] for s in stats],
                       "host_ms_median": statistics.median(s["host_ms"] for s in stats),
                       "sprite_raster_launches": stats[-1]["sprite_raster"]}
    cache.clear()
    lens, blob, objs = cs.filter_scene()
    before = kernels.launches["sprite_raster"]
    _, stats = cs.filter_frames(torch, dev, lens, blob, objs, cs.N_GENERAL_FRAMES, scratch=0, whole=False)
    rows["general_filters"] = {"incremental": cs.frame_stats([s["incremental"]["event_ms"] for s in stats]),
                               "incremental_host_ms": cs.frame_stats([s["incremental"]["host_ms"] for s in stats]),
                               "sprite_raster_launches": kernels.launches["sprite_raster"] - before}
    cache.clear()
    cs.emit({"e2e": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package and chip_smoke.py)")
    ap.add_argument("--parent", metavar="DIR", help="a checkout of another design, run in turns with this one")
    ap.add_argument("--split", action="store_true", help="split the kernel's time by probes")
    ap.add_argument("--e2e", action="store_true", help="the rebuild, the fold route and the filtered frames")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.append(here)  # profile_smear.compile_sources

    import torch

    if not torch.cuda.is_available():
        print("profile_sprite: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from coherence_tpu_torch import kernels

    for mod in (cs, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"profile_sprite: {mod.__name__} came from {mod.__file__}, not from {tree}")
    dev = "cuda"
    t0 = time.perf_counter()
    ptxas = kernels.build()
    kernels.load()
    parent = None
    if args.parent:
        parent = load_tree(args.parent)
        parent.build()
        parent.load()
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB, past the 50 MB L2
    floor = cs.event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    last = {"tree": tree, "parent": args.parent and os.path.abspath(args.parent), "launch_floor_ms": floor}
    if args.e2e:
        e2e(torch, cs, kernels, dev)
    elif args.split:
        last["ptxas_probes"] = split(torch, cs, kernels, parent, scrub, dev)
    else:
        compare(torch, cs, kernels, parent, scrub, dev)
    last["ptxas_sprite_raster"] = ptxas_lines(ptxas, "sprite_raster")
    print(json.dumps({**last, "retaken": cs.RETAKEN[0], "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
