#!/usr/bin/env python3
"""Time the brush kernels at the program's shapes on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_brush.py [--tree DIR]
    python3 profile_brush.py --split FIRST [--tree DIR]
    python3 profile_brush.py --probe
    python3 profile_brush.py --phase-turns
    python3 profile_brush.py --demos [--tree DIR]
    python3 profile_brush.py --host-against DIR
    python3 profile_brush.py --host-split [--tree DIR]

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
kernel's ms (its lists' staged copy in the window), its plain version's
and the wrapper's host ms, and where the tree's ``brush_row`` gives them
the kernel alone on lists staged beforehand (kernel_ms), the staged copy
alone (copy_ms) and the lists a block reads; the launch floor (an empty
kernel timed the same way), the tree, and the card's name and power limit.

--split splits brush_stamp's time at BR1's five shapes (``plane_31x31``,
``plane_r120``, config 5's groups): FIRST is a checkout of the first
design (e42b14a: 16x128 strips that read every record of their stroke in
rounds of 256); its ``brush_stamp.cu`` is compiled alone by
``nvcc`` into ``build/brush_variants/`` with variants that each keep one
part (``split_sources``; wrong on purpose): ``empty`` the launch alone,
``staging`` the patch staging and the output, ``rounds`` everything but the
fold, ``fold_given`` the fold of each block's list as ``kernels``' lists
give it, with no rounds (every variant reads the records of FIRST's
``kernels.pack_brush_records``); and ``fold_ilp``, the first design with this
design's fold (its loads before its blends), right and whole.  Each is called on lists staged beforehand, in
turns with the first design (``chip_smoke.in_turns``: first, variant,
variant, first), and the tree's own kernel likewise where its ``kernels``
stages its lists apart (``stage_brush_lists``); then the staged copy alone
of each layout.  Last the ptxas lines of each build.

--probe times probes of this checkout's ``brush_stamp.cu`` (``probe_sources``:
variants that change one part, wrong on purpose, compiled alone into
``build/brush_variants/``) in turns with its kernel on its lists staged
beforehand, at the five shapes: ``nomath`` adds each texel in place of the
blend, ``noload`` folds a value made from the stamp's place in place of
the texel read (shared memory path), ``nofold`` skips the fold, ``clamp`` reads the patch in shared
memory as the device-memory path does (rows clamped, no zero pads; right),
``noskip`` as clamp with every entry kept in every warp's list (right),
``device`` reads every patch from device memory, as a patch past
``kernels.BRUSH_PATCH_SMEM`` is read (right);
``timeline`` computes as the kernel does but
writes, in place of its output, each block's start and end on the card's
global timer, its SM's cycles between them and its SM, from which it
prints the span of the launch, the blocks' durations and the SM clock.

--demos renders the general renderer's ``brush`` and ``monobrush`` demos
as ``chip_smoke.general_filters`` does (each placed over every fourth path
of the lion at 1920x1080, the lion's sprites cached by a render of the lion
alone first), five times each with the coherence cache emptied between,
and prints each render's CUDA-event and synchronized host ms
(``chip_smoke.measured``) and the brush_stamp launches; with --tree, for
another checkout in turns.

--host-against DIR times the wrappers' host side, this checkout's
against DIR's (its ``kernels`` module loaded by path as a package beside
this one's, its library built in its own ``build/``), in one process at
the five shapes: the call the program makes (``brush_stamp_planes``, or
``brush_stamp_pieces`` of the group's lists as ``_group_block`` makes
them: packing, staged copy, launch, not waited for), DIR's and this
checkout's in the order A, B, B, A, 60 times; per tree the median and
quartiles of its 120 calls, host clock.

--host-split times the same host calls as --host-against, for one
checkout (--tree), 200 times at each of the five shapes, and splits each
call by the functions it passes through (``HOST_STEPS``: every one that the
tree's ``kernels``, ``native_lib`` and ``raster/staging`` define is wrapped
by a timer): per step its median ms of a call (a step called within
another counts in both), and the median whole call, host clock.

--phase-turns settles whether ``chip_smoke.py``'s ``brush_kernels`` phase
and this script's loop read BR1 alike: in one process, on the same
inputs, the phase, the loop over the five stamp shapes and the loop over
every shape with the smears between them (as the phase and the default
mode run them), in the order phase, loop, smears, smears, loop, phase,
each printing BR1's ms, and the kernel alone and the copy where the tree's
``brush_row`` gives them, per shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

VARIANT_DIR = os.path.join("build", "brush_variants")
STAMP_SHAPES = ("plane_31x31", "plane_r120", "config5_group0", "config5_group1", "config5_zoom2x_group0")


def split_sources(kernels, first: str, directory: str) -> dict:
    """name -> .cu path: the first design's brush_stamp.cu and, written
    into `directory`, its variants that keep one part each (wrong on
    purpose; the entry point unchanged):

      * empty: the launch alone (the body returns at once);
      * staging: the patch staged into shared memory, then the output;
      * rounds: the records read in rounds and compacted, no fold;
      * fold_given: no rounds; the block folds the stamp list of
        brush_plane_lists / brush_piece_lists (its entries in `stamps`, the
        ranges in `points`: the list of its bin, which the first of this
        design's strips in it reads), every piece pixel in the mask;
      * fold_ilp: the whole first design, its fold's eight loads made
        before its blends (clamped and masked, no test of a texel), as this
        design folds (right, not wrong)."""
    with open(first) as f:
        src = f.read()
    rounds_at = src.index("  for (int base = 0; base < p.n; base += kThreads) {")
    rounds_end = src.index("    __syncthreads();  // the next round's lists take these ones' place\n  }\n")
    rounds_end += len("    __syncthreads();  // the next round's lists take these ones' place\n  }\n")
    fold_at = src.index("    // The listed stamps, in order, into this thread's column.\n")
    fold = src[fold_at : src.index("    if constexpr (kPiece) {\n      for (int k = 0; k < mp; ++k) {")]
    sh, bin_h = kernels.BRUSH_BLOCK[0], kernels.BRUSH_BIN[0]  # the lists' strips and bins
    given = (
        "  {  // split: the given list of this block, no rounds\n"
        f"    const int per = kStripH / {sh}, sy = (p.hp + {sh - 1}) / {sh};  // the lists' strips a strip here\n"
        "    const int b = kPiece ? blockIdx.x / kStrips * (kStrips * per) + blockIdx.x % kStrips * per\n"
        "                         : (blockIdx.y * sy + blockIdx.x / p.tiles_x * per) * p.tiles_x + blockIdx.x % p.tiles_x;\n"
        f"    const int bin_y = kPiece ? ty0 - blockIdx.x % kStrips * kStripH : ty0 - ty0 % {bin_h};\n"
        "    const int4* given = reinterpret_cast<const int4*>(p.points);\n"
        "    const int* entries = reinterpret_cast<const int*>(p.stamps);\n"
        "    const int first = given[b].x, last = given[b].y;\n"
        "    covered = ~0u;\n"
        "    for (int base = first; base < last; base += kThreads) {\n"
        "      const int m = min(kThreads, last - base);\n"
        "      if (threadIdx.x < m) {\n"
        "        const int e = entries[base + threadIdx.x];\n"
        "        stamp_list[threadIdx.x] = make_int2(bin_y + static_cast<short>(e & 0xffff) - ky0, tx0 + (e >> 16) - kx0);\n"
        "      }\n"
        "      __syncthreads();\n"
        f"{fold}"
        "      __syncthreads();\n"
        "    }\n"
        "  }\n"
    )
    ilp = (
        "    for (int k = 0; k < m; ++k) {  // split: the fold's loads made before its blends\n"
        "      const int2 o = stamp_list[k];\n"
        "      const int kx = x - o.y - kx0, ky = y0 - o.x - ky0;\n"
        "      const int inside = static_cast<unsigned>(kx) < static_cast<unsigned>(kw) ? 0xFF : 0;\n"
        "      const unsigned char* column = texels + min(max(kx, 0), kw - 1);\n"
        "      int t[kRows];\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < kRows; ++j) {\n"
        "        const int row = ky + j;\n"
        "        t[j] = column[min(max(row, 0), kh - 1) * kw] & (static_cast<unsigned>(row) < static_cast<unsigned>(kh) ? inside : 0);\n"
        "      }\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < kRows; ++j) alpha[j] = prelerp(alpha[j], t[j]);\n"
        "    }\n"
    )
    fold_loop = fold[fold.index("    for (int k = 0; k < m; ++k) {"):]
    body = "  __shared__ int counts[2][kWarps];\n"
    edits = {
        "empty": src.replace(body, body + "  if (p.n >= 0) return;  // split: the launch alone\n", 1),
        "staging": src[:rounds_at] + "  __syncthreads();  // split: the patch staging alone\n"
                   "  alpha[0] = kh * kw ? texels[threadIdx.x % (kh * kw)] : 0;\n" + src[rounds_end:],
        "rounds": src.replace("    for (int k = 0; k < m; ++k) {", "    alpha[0] += m + stamp_list[0].x;  // split: no fold\n"
                              "    for (int k = 0; k < 0; ++k) {", 1)
                     .replace("      for (int k = 0; k < mp; ++k) {", "      covered |= mp;\n"
                              "      for (int k = 0; k < 0; ++k) {", 1),
        "fold_given": src[:rounds_at] + given + src[rounds_end:],
        "fold_ilp": src.replace(fold_loop, ilp, 1),
    }
    os.makedirs(directory, exist_ok=True)
    out = {"first": first}
    for name, text in edits.items():
        if text == src:
            raise RuntimeError(f"profile_brush: the {name} edit found nothing to change in {first}")
        out[name] = os.path.join(directory, f"{name}.cu")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def split(torch, cs, kernels, first_dir: str, scrub) -> dict:
    """--split: per shape, the first design and its variants in turns on
    lists staged beforehand, the tree's kernel likewise, the copies alone."""
    from coherence_tpu_torch.raster import staging
    from coherence_tpu_torch.raster.brush_tiles import _group_lists
    from profile_smear import compile_sources

    dev = "cuda"
    first_kernels = tree_kernels(first_dir)  # its pack_brush_records: the first design's records
    first = os.path.join(first_dir, "coherence_tpu_torch", "kernels", "csrc", "brush_stamp.cu")
    built = compile_sources(kernels, split_sources(kernels, first, VARIANT_DIR), VARIANT_DIR)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(os.path.abspath(lib)).brush_stamp
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        fn.restype = i32
        entries[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    inputs = cs.brush_inputs(torch, dev)
    for shape in STAMP_SHAPES:
        mode, args = inputs[shape]
        if mode == "plane":
            brushes, offsets, valid, hp, wp, _ = args
            records = first_kernels.pack_brush_records(brushes, offsets, valid, hp, wp)
            arrays = [records[0], records[2], records[3]]
            lists = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
            out_shape, pieces = (len(brushes), hp, wp), 0
        else:
            build, gkey = args
            brushes, offsets, valid, points, fills, radii, meta = _group_lists(gkey[4], build.groups[gkey])
            hp, wp = gkey[:2]
            records = first_kernels.pack_brush_records(brushes, offsets, valid, hp, wp, points, fills, radii)
            arrays = [*records, meta]
            lists = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp, wp)
            out_shape, pieces = (len(meta), 64, 128), len(meta)
        staged = staging.stage(dev, *arrays)
        st, pt, strokes_d, patches_d, meta_d = staged if mode != "plane" else (staged[0], staged[0], staged[1],
                                                                              staged[2], staged[1])
        entries_d, ranges_d = staging.stage(dev, lists.stamps, lists.ranges)
        s, n = records[0].shape[:2]

        def launcher(fn, given):
            def call():
                out = torch.empty(out_shape, dtype=torch.int32, device=dev)
                a, b = (entries_d, ranges_d) if given else (st, pt)
                cs.require(fn(a.data_ptr(), b.data_ptr(), strokes_d.data_ptr(), patches_d.data_ptr(),
                              meta_d.data_ptr(), out.data_ptr(), int(mode != "plane"), s, n, hp, wp, pieces,
                              stream) == 0, "a variant's launch failed")
                return out
            return call

        calls = {name: launcher(fn, name == "fold_given") for name, fn in entries.items()}
        want = calls["first"]()
        row = {"shape": shape, **kernels.brush_list_stats(lists)}
        if hasattr(kernels, "stage_brush_lists"):
            mine = kernels.stage_brush_lists(lists, dev)
            calls["this"] = lambda: kernels.brush_stamp(lists, mine)
        torch.cuda.synchronize()
        for name, call in calls.items():
            if name == "first":
                continue
            equal = bool(torch.equal(call(), want))
            turns = cs.in_turns(torch, call, scrub, wait_ms=cs.ANIMATED_WAIT_MS, first=calls["first"])
            cs.emit({**row, "variant": name, "equal_first": equal, **turns})
        copies = {"copy_first_ms": cs.event_ms(torch, lambda: staging.stage(dev, *arrays), scrub,
                                               wait_ms=cs.ANIMATED_WAIT_MS, queued=True)}
        if hasattr(kernels, "stage_brush_lists"):
            copies["copy_this_ms"] = cs.event_ms(torch, lambda: kernels.stage_brush_lists(lists, dev), scrub,
                                                 wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
        cs.emit({**row, **copies})
    ptxas = {}
    for who, (_, log) in built.items():
        ptxas[who] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return ptxas


def probe_sources(src_path: str, directory: str) -> dict:
    """name -> .cu path: probes of this checkout's brush_stamp.cu (its entry
    point unchanged), written into `directory` (--probe says what each
    changes)."""
    with open(src_path) as f:
        src = f.read()
    start, end = "  const int b = blockIdx.x;\n", "  const int x = tx0 + col, y0 = ty0 + r0;\n"
    timeline = src.replace(start, start + (
        "  long long probe_t0;  // probe: the block's start\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_t0));\n"
        "  const long long probe_c0 = clock64();\n"), 1).replace(end, (
        "  {  // probe: the block's end, cycles and SM in place of its output\n"
        "    __syncthreads();\n"
        "    long long t1;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
        "    const long long c1 = clock64();\n"
        "    unsigned smid;\n"
        "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
        "    int sum = static_cast<int>(covered);\n"
        "    for (int j = 0; j < kRows; ++j) sum += alpha[j];\n"
        "    long long* o = reinterpret_cast<long long*>(p.out) + 4 * static_cast<long>(b);\n"
        "    if (threadIdx.x == 0) o[0] = probe_t0, o[1] = t1, o[2] = c1 - probe_c0, o[3] = smid;\n"
        "    if (sum == 0x7fffffff) p.out[1] = sum;  // keeps the fold\n"
        "    return;\n"
        "  }\n") + end, 1)
    edits = {
        "timeline": timeline,
        "nomath": src.replace("for (int j = 0; j < kRows; ++j) alpha[j] = prelerp(alpha[j], t[q][j]);",
                              "for (int j = 0; j < kRows; ++j) alpha[j] += t[q][j];  // probe: no blend", 1),
        "noload": src.replace("t[q][j] = column[(ky + j) * kw] & inside;",
                              "t[q][j] = (kx + ky + j) & inside;  // probe: no texel read", 1),
        "nofold": src.replace("for (int k = 0; k < n; k += kBatch) {",
                              "for (int k = 0; k < 0; k += kBatch) {  // probe: no fold", 1),
        "clamp": src.replace("walk<false>(alpha, stamp_list, mine, p.stamps, lists.x, lists.y, patch_s + patch_pad(kw)",
                             "walk<true>(alpha, stamp_list, mine, p.stamps, lists.x, lists.y, patch_s + patch_pad(kw)", 1),
    }
    edits["device"] = src.replace("const bool shared = patch_bytes(kh, kw) <= p.patch_smem;",
                                  "const bool shared = false && patch_bytes(kh, kw) <= p.patch_smem;  // probe", 1)
    edits["noskip"] = edits["clamp"].replace(
        "return ry < r0 + kRows && ry + kh > r0 && rx < wx + 32 && rx + kw > wx;",
        "return ry == ry && rx == rx;  // probe: every entry", 1)
    os.makedirs(directory, exist_ok=True)
    out = {}
    for name, text in edits.items():
        if text == src:
            raise RuntimeError(f"profile_brush: the {name} probe found nothing to change in {src_path}")
        out[name] = os.path.join(directory, f"probe_{name}.cu")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def timeline_stats(torch, out, blocks: int, lengths) -> dict:
    """A timeline probe's output: per block (start ns, end ns, SM cycles,
    SM) -> the launch's span, the blocks' start spread and durations, the
    SM clock, the blocks an SM ran, and the longest block's list."""
    t = out.reshape(-1)[: 8 * blocks].view(torch.int64).view(blocks, 4).cpu().double()
    dur = t[:, 1] - t[:, 0]
    slowest = int(dur.argmax())
    return {"span_us": float(t[:, 1].max() - t[:, 0].min()) / 1e3,
            "start_spread_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3,
            "block_us_median": float(dur.median()) / 1e3, "block_us_max": float(dur.max()) / 1e3,
            "cycles_median": float(t[:, 2].median()), "cycles_max": float(t[:, 2].max()),
            "ghz": float((t[:, 2] / dur.clamp(min=1)).median()),
            "blocks_per_sm_max": int(torch.bincount(t[:, 3].long()).max()),
            "slowest_block": slowest, "slowest_lists": [int(v) for v in lengths[slowest]]}


def probe(torch, cs, kernels, scrub) -> dict:
    """--probe: per shape each probe in turns with this checkout's kernel."""
    from coherence_tpu_torch.raster.brush_tiles import _group_lists
    from profile_smear import compile_sources

    dev = "cuda"
    src = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "csrc", "brush_stamp.cu")
    built = compile_sources(kernels, {"this": src, **probe_sources(src, VARIANT_DIR)}, VARIANT_DIR)
    this_log = built.pop("this")[1]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(os.path.abspath(lib)).brush_stamp
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        fn.restype = i32
        entries[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    inputs = cs.brush_inputs(torch, dev)
    for shape in STAMP_SHAPES:
        mode, args = inputs[shape]
        if mode == "plane":
            brushes, offsets, valid, hp, wp, _ = args
            lists = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
        else:
            build, gkey = args
            lists = kernels.brush_piece_lists(*_group_lists(gkey[4], build.groups[gkey]), *gkey[:2])
        staged = kernels.stage_brush_lists(lists, dev)
        blocks = len(lists.ranges)

        def launcher(fn):
            def call():
                out = torch.empty(lists.shape, dtype=torch.int32, device=dev)
                cs.require(fn(*(t.data_ptr() for t in staged), out.data_ptr(), int(lists.piece), blocks, lists.hp,
                              lists.wp, lists.patch_smem, stream) == 0, "a probe's launch failed")
                return out
            return call

        this = lambda: kernels.brush_stamp(lists, staged)  # noqa: E731
        want = this()
        row = {"shape": shape, **kernels.brush_list_stats(lists), "patch_smem": lists.patch_smem,
               "blocks_per_sm": kernels.brush_stamp_blocks_per_sm(lists.piece, lists.patch_smem)}
        for name, fn in entries.items():
            got = launcher(fn)()
            torch.cuda.synchronize()
            extra = {}
            if name == "timeline":
                lengths = lists.ranges[:, 1::2] - lists.ranges[:, 0::2]
                extra = timeline_stats(torch, got, blocks, lengths)
            else:
                extra = {"equal_this": bool(torch.equal(got, want))}
            turns = cs.in_turns(torch, launcher(fn), scrub, wait_ms=cs.ANIMATED_WAIT_MS, this=this)
            cs.emit({**row, "probe": name, **extra, **turns})
    return {who: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for who, log in [("this", this_log), *((w, lg) for w, (_, lg) in built.items())]}


def demos(torch, cs, kernels, reps: int = 5) -> None:
    """--demos: the brush demos' renders, as general_filters renders them."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import examples
    from coherence_tpu_torch.scene import render as R

    dev = "cuda"
    objs = cs.filter_scene()[2][:: cs.DEMO_LION_STRIDE]
    for name in ("brush", "monobrush"):
        demo = R.position_anchor(R.Centre, (float(cs.W * 3 // 16), float(cs.H // 2)), getattr(examples, name)())
        rows = []
        for _ in range(reps):
            cs.fresh_cache()
            shape = region.shape_of_box(cs.WINDOW, dev)
            R.render_simple_scene(objs, shape, dev)
            before = kernels.launches["brush_stamp"]
            _, st = cs.measured(torch, dev, lambda: R.render_simple_scene([demo] + objs, shape, dev))
            rows.append({"event_ms": st["event_ms"], "host_ms": st["host_ms"],
                         "brush_stamp": kernels.launches["brush_stamp"] - before})
        cs.emit({"demo": name, "renders": rows})

def tree_kernels(directory: str):
    """The ``kernels`` module of the checkout at `directory`, loaded by path
    as a package beside this one's (its library built in its own
    ``build/``; its relative imports resolve to this tree's package)."""
    import importlib.util

    name = "coherence_tpu_torch.kernels_of_" + str(abs(hash(os.path.abspath(directory))))
    if name in sys.modules:
        return sys.modules[name]
    init = os.path.join(os.path.abspath(directory), "coherence_tpu_torch", "kernels", "__init__.py")
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def host_against(torch, cs, kernels, against_dir: str, rounds: int = 60) -> None:
    """--host-against: the wrappers' host side, DIR's against this tree's."""
    import statistics

    from coherence_tpu_torch.raster.brush_tiles import _group_lists

    against = tree_kernels(against_dir)
    against.load()
    dev = "cuda"
    inputs = cs.brush_inputs(torch, dev)
    for shape in STAMP_SHAPES:
        mode, args = inputs[shape]
        if mode == "plane":
            brushes, offsets, valid, hp, wp, _ = args
            calls = {who: (lambda m=m: m.brush_stamp_planes(brushes, offsets, valid, hp, wp, dev))
                     for who, m in (("against", against), ("this", kernels))}
        else:
            build, gkey = args
            items = build.groups[gkey]
            calls = {who: (lambda m=m: m.brush_stamp_pieces(*_group_lists(gkey[4], items), *gkey[:2], dev))
                     for who, m in (("against", against), ("this", kernels))}
        ms = {"against": [], "this": []}
        for who in ms:
            calls[who]()  # one untimed call each first
        torch.cuda.synchronize()
        for _ in range(rounds):
            for who in ("against", "this", "this", "against"):
                t0 = time.perf_counter()
                calls[who]()
                ms[who].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        row = {"shape": shape}
        for who, values in ms.items():
            q1, q2, q3 = statistics.quantiles(values, n=4)
            row[f"{who}_host_ms"], row[f"{who}_host_ms_quartiles"] = q2, [q1, q3]
        cs.emit(row)

# (module, function) pairs --host-split times: the wrappers' checks, the
# stroke table, the lists, the staged copy and the launch, of this design and
# of the first (pack_brush_records, patch_extent, _brush_stamp).
HOST_STEPS = (
    ("kernels", "brush_plane_lists"), ("kernels", "brush_piece_lists"), ("kernels", "pack_brush_records"),
    ("kernels", "_stamp_arrays"), ("kernels", "_int32"), ("kernels", "_stroke_table"), ("kernels", "patch_extent"),
    ("native_lib", "brush_stroke_table"), ("native_lib", "brush_strip_lists"), ("staging", "stage"),
    ("kernels", "brush_stamp"), ("kernels", "_brush_stamp"),
)


def host_split(torch, cs, kernels, rounds: int = 200) -> None:
    """--host-split: the wrapper's host side at each shape, step by step."""
    import statistics

    from coherence_tpu_torch import native_lib
    from coherence_tpu_torch.raster import staging
    from coherence_tpu_torch.raster.brush_tiles import _group_lists

    modules = {"kernels": kernels, "native_lib": native_lib, "staging": staging}
    spent = {}

    def timed(label, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[label] = spent.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    wrapped = [(modules[m], name, getattr(modules[m], name)) for m, name in HOST_STEPS if hasattr(modules[m], name)]
    dev = "cuda"
    inputs = cs.brush_inputs(torch, dev)
    try:
        for mod, name, fn in wrapped:
            setattr(mod, name, timed(name, fn))
        for shape in STAMP_SHAPES:
            mode, args = inputs[shape]
            if mode == "plane":
                brushes, offsets, valid, hp, wp, _ = args
                call = lambda: kernels.brush_stamp_planes(brushes, offsets, valid, hp, wp, dev)  # noqa: E731
            else:
                build, gkey = args
                group = _group_lists(gkey[4], build.groups[gkey])
                call = lambda: kernels.brush_stamp_pieces(*group, *gkey[:2], dev)  # noqa: E731
            call()
            torch.cuda.synchronize()
            calls = []
            for _ in range(rounds):
                spent.clear()
                t0 = time.perf_counter()
                call()
                calls.append({"call": (time.perf_counter() - t0) * 1e3, **spent})
                torch.cuda.synchronize()
            steps = sorted({k for c in calls for k in c})
            cs.emit({"shape": shape, "calls": rounds,
                     "median_ms": {k: statistics.median(c.get(k, 0.0) for c in calls) for k in steps}})
    finally:
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)


def phase_turns(torch, cs, kernels, scrub, floor: float) -> None:
    """--phase-turns: brush_kernels (phase), the loop of brush_row over the
    five stamp shapes (loop) and over every shape of brush_inputs, the
    smears between the planes and the pieces as in brush_kernels (smears),
    in the order phase, loop, smears, smears, loop, phase, in one process."""
    dev = "cuda"
    keys = ("ms", "kernel_ms", "copy_ms", "wait_ms")
    for k, who in enumerate(("phase", "loop", "smears", "smears", "loop", "phase")):
        if who == "phase":
            rows = cs.brush_kernels(torch, dev, kernels, scrub, floor)["brush_stamp"]["shapes"]
        else:
            rows = {name: cs.brush_row(torch, dev, scrub, mode, args)
                    for name, (mode, args) in cs.brush_inputs(torch, dev).items()
                    if who == "smears" or name in STAMP_SHAPES}
        cs.emit({"turn": k, "who": who, "shapes": {name: {key: rows[name].get(key) for key in keys}
                                                   for name in STAMP_SHAPES}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout to run (its package and chip_smoke.py)")
    ap.add_argument("--split", metavar="FIRST", help="a checkout of the first design: split its time")
    ap.add_argument("--probe", action="store_true", help="probes of this checkout's kernel in turns with it")
    ap.add_argument("--phase-turns", action="store_true", help="brush_kernels and this loop in turns")
    ap.add_argument("--demos", action="store_true", help="the brush demos' renders")
    ap.add_argument("--host-against", metavar="DIR", help="the wrappers' host side against DIR's")
    ap.add_argument("--host-split", action="store_true", help="the wrappers' host side, step by step")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.append(here)  # profile_smear.compile_sources

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
    floor = cs.event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.split:
        ptxas = split(torch, cs, kernels, os.path.abspath(args.split), scrub)
        print(json.dumps({"tree": tree, "ptxas_brush_stamp": ptxas, "launch_floor_ms": floor, "nvidia_smi": smi,
                          "retaken": cs.RETAKEN[0], "seconds": time.perf_counter() - t0}))
        return 0
    if args.probe:
        ptxas = probe(torch, cs, kernels, scrub)
        print(json.dumps({"tree": tree, "ptxas_brush_stamp": ptxas, "launch_floor_ms": floor, "nvidia_smi": smi,
                          "retaken": cs.RETAKEN[0], "seconds": time.perf_counter() - t0}))
        return 0
    if args.host_against:
        host_against(torch, cs, kernels, args.host_against)
        print(json.dumps({"tree": tree, "against": os.path.abspath(args.host_against), "nvidia_smi": smi,
                          "seconds": time.perf_counter() - t0}))
        return 0
    if args.host_split:
        host_split(torch, cs, kernels)
        print(json.dumps({"tree": tree, "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
        return 0
    if args.demos:
        demos(torch, cs, kernels)
        print(json.dumps({"tree": tree, "nvidia_smi": smi, "seconds": time.perf_counter() - t0}))
        return 0
    if args.phase_turns:
        phase_turns(torch, cs, kernels, scrub, floor)
        print(json.dumps({"tree": tree, "launch_floor_ms": floor, "nvidia_smi": smi,
                          "seconds": time.perf_counter() - t0}))
        return 0
    rows = {}
    keys = ("ms", "plain_ms", "host_ms", "host_ms_max", "kernel_ms", "copy_ms", "blocks", "stamp_list_max",
            "stamp_list_mean")
    for name, (mode, inputs) in cs.brush_inputs(torch, dev).items():
        row = cs.brush_row(torch, dev, scrub, mode, inputs)
        rows[name] = {k: row[k] for k in keys if k in row}
    print(json.dumps({"tree": tree, "shapes": rows, "launch_floor_ms": floor, "nvidia_smi": smi,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
