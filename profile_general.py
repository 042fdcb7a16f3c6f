#!/usr/bin/env python3
"""Profile the port's general renderer on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 profile_general.py [--out build/profile_general]

The general renderer (``render_simple_scene`` down through ``render_scene``,
the coherence cache, ``region.caf`` and the anti-aliased polygon sprite)
is mostly eager torch operations; its hand-written kernels are the group
fold (``fold_layers``), the sprite rasterizer (``sprite_raster``), the
brush stamp walk (``brush_stamp``), the smear (``smear_walk``) and the
region programs (``caf``, ``tight_bounds``, ``box_morph``,
``convolve_canvas``).  This script says what it costs.  It builds
``chip_smoke.py``'s ``general_lion`` scene (the lion fitted to 1024 pixels
in a 1920 x 1080 window) and writes, under --out:

  * rebuild_profile.txt: a ``torch.profiler`` window of one render after
    ``cache.clear()``: device time, device operations (device rows only:
    the ``aten::`` rows repeat their kernels' time), and the table;
  * rebuild_cprofile.txt: cProfile of one more such render;
  * programs.txt: for each device program the JAX package jits on this path
    (``_caf_kernel``, ``_dilate``, ``_erode_k``, ``_convolve_canvas_jit``,
    ``_stamp_scan_alpha``, ``_smear_scan``, the coverage product, ...), the
    port's counterpart called five times under the profiler at a stated
    shape: per call its device operations (the card's rows), the launches
    and copies the host issued (the runtime's rows), and its device time.
    The brush stroke's and the smear's walks also stand alone ("stamp
    walk", "smear walk": the brush_stamp and smear_walk kernels' calls as
    those two programs make them).

It prints, last, one JSON line with those totals, the unprofiled host and
CUDA-event milliseconds of a rebuild and of a warm render, the host syncs
``raster/region.py`` counted, and the card's name and power limit.  The
profiler slows the host several times over, so read its window for counts
and shares, and the unprofiled lines for times.

    python3 profile_general.py --split [--out build/profile_general]

instead splits the ``general_lion`` rebuild on both routes: unprofiled
times of each (host clock after a synchronize), then one rebuild of each
under cProfile (written to split_batched.txt and split_fold.txt), read as
the cumulative seconds of the parts that ``SPLIT_PARTS`` names: the host
sweep, the batched members' raster and its parts, the scalar members, the
fold and the cache seeding; on the per-member fold route every object's
``coverage_opacity``.

    python3 profile_general.py --filters

instead splits ``chip_smoke.py``'s ``general_filters`` frames (the bench
scene under the radius-5 blur lens, the blob dragged beneath it): for one
steady incremental frame and for the whole-window render after it, the
launches and copies the host issued (``issued``), the torch operations
dispatched under each outermost function of ``raster/region.py``,
``raster/convolve.py`` and ``raster/aa.py`` (``outermost_split``: a
``TorchDispatchMode`` reading the Python stack at each operation), the
hand-written kernels launched under each, and the host syncs
``raster/region.py`` counted.  Frames 0-2 warm the scene and the caches;
frame 3 is split, frame 4 counted under the profiler.  It also counts
the launches and copies issued by ``general_lion``'s rebuild on each route
and by the three pages of ``chip_smoke.py``'s PDF document painted cold,
as ``pdf_pages`` counts them.  Run it in two checkouts in one call (the
parent unpacked under ``build/parent``, this file copied there) to
compare them.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time


def device_rows(prof):
    """The profile's device rows: kernels and copies.  The aten:: rows
    repeat their kernels' time; the runtime rows are host calls."""
    return [e for e in prof.key_averages() if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "cuda", "Activity Buffer"))]


RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def launch_calls(prof) -> int:
    """Launches and copies as the host issued them (the runtime's rows).  A
    window of a few microseconds can close before the card's own records
    arrive, so a short window is counted from these."""
    return sum(e.count for e in prof.key_averages() if e.key.startswith(RUNTIME_CALLS))


def issued(torch, fn) -> int:
    """launch_calls of fn() under a profiler that records the CUDA runtime
    alone (no operator rows), read from its raw records instead of its
    table: a window of tens of thousands of calls is counted in seconds,
    where building the table takes about a minute."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events() if e.name().startswith(RUNTIME_CALLS))


def profiled(torch, fn, reps: int = 1):
    """(result, profile, device operations, device ms, host seconds, issued
    launches and copies) of fn() under the profiler, each per call over
    `reps` calls in one window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / reps
    rows = device_rows(prof)
    return (out, prof, sum(e.count for e in rows) / reps, sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            seconds, launch_calls(prof) / reps)


def programs(torch, dev):
    """name -> (the JAX package's jitted program, the shape, a thunk of the
    port's counterpart)."""
    import numpy as np

    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import aa, brush, convolve, fills, region, scanline

    rng = np.random.default_rng(0)
    n = 512

    def shape_at(x0, y0, seed):
        return region.shape_of_mask((x0, y0, x0 + n - 1, y0 + n - 1), np.random.default_rng(seed).random((n, n)) < 0.5, dev)

    a, b = shape_at(1, 1, 1), shape_at(200, 100, 2)
    grad = fills.gradient((0.0, 0.0), (700.0, 600.0), True, True, C.red, C.dissolve(C.blue, delta=120))
    sa, sb = region.fillshape(a, grad), region.fillshape(b, fills.plain(C.dissolve(C.gold, delta=200)))
    circle = gshapes.circle(300.0, 300.0, 250.0)
    edges = gpath.edgelist_of_path(circle)
    cshape, cmin = scanline.shapeminshape_of_edgelist(edges, circle.winding, dev)
    fringe = region.boxshape(region.shape_difference(cshape, cmin))
    stroke = (brush.mkround(15.0, 0.5), circle)
    bshape, _ = brush.shape_of_brushstroke(stroke, dev)
    frame = torch.from_numpy(rng.integers(0, 256, (1088, 1920, 4)).astype(np.int32)).to(dev)
    whole = torch.ones((1088, 1920), dtype=torch.bool, device=dev)
    k5 = convolve.mkgaussian(5)
    out = {
        "caf over": ("region._caf_kernel", "two 512x512 sprites, union box 711x611",
                     lambda: region.caf("over", "opaque", sa, sb)),
        "shape_union": ("region._shift_mask + _or", "two 512x512 masks", lambda: region.shape_union(a, b)),
        "shape_difference": ("region._shift_mask + _andnot", "two 512x512 masks", lambda: region.shape_difference(a, b)),
        "shape_intersection": ("region._extract_mask + _and", "two 512x512 masks", lambda: region.shape_intersection(a, b)),
        "is_null_shape": ("region._any", "512x512 mask, one sync",
                          lambda: region.is_null_shape(region.Shape(a.box, a.mask))),
        "boxshape": ("region._tight_bounds + _extract_mask", "711x611 mask, one sync",
                     lambda: region.boxshape(region.shape_union(a, b))),
        "portion": ("region._extract_* + _and + _masked_rgba", "512x512 sprite by a 512x512 shape",
                    lambda: region.portion(sa, b)),
        "fillshape plain": ("region._masked_rgba", "512x512", lambda: region.fillshape(a, fills.plain(C.red))),
        "fillshape gradient": ("region._masked_rgba after a host plane", "512x512, 4 MiB uploaded",
                               lambda: region.fillshape(a, grad)),
        "bloat": ("region._dilate", "512x512 by (5, 5)", lambda: region.bloat(5, 5, a)),
        "erode": ("region._erode_k", "512x512 by (5, 5)", lambda: region.erode(5, 5, a)),
        "polygon_sprite fringe": ("aa._coverage_counts_jit + _aa_sprite_rgba", "the fringe of a circle of radius 250",
                                  lambda: aa.polygon_sprite_edgelist(fills.plain(C.red), fringe, edges, circle.winding)),
        "convolve_canvas xy": ("convolve._convolve_canvas_jit", "1088x1920, mkgaussian(5)",
                               lambda: convolve.convolve_canvas(k5, frame, whole)),
        "convolve_sprite": ("convolve._convolve_canvas_jit + flatten + pickup", "512x512 sprite, mkgaussian(5)",
                            lambda: convolve.convolve_sprite(k5, sa)),
        "sprite_of_brushstroke": ("brush._stamp_scan_alpha", f"{len(brush.points_of_brushstroke(stroke))} stamps of a 31x31 brush",
                                  lambda: brush.sprite_of_brushstroke(stroke, fills.plain(C.darkorange), bshape, dev)),
        "smear": ("brush._smear_scan", f"{len(brush.points_of_brushstroke_smear(stroke))} steps over a 711x611 sprite",
                  lambda: brush.smear(region.caf("over", "opaque", sa, sb)[0], stroke, dev)),
    }
    out["stamp walk"] = ("brush._stamp_scan_alpha", "the sprite_of_brushstroke row's stamps alone",
                         replayed(out["sprite_of_brushstroke"][2], "_stamp_alpha"))
    out["smear walk"] = ("brush._smear_scan x 2", "the smear row's steps alone, both passes",
                         replayed(out["smear"][2], "_smear_walk"))
    return out


@contextlib.contextmanager
def recorded_brush_calls():
    """Inside, every raster/brush.py _stamp_alpha and _smear_walk call
    appends (name, args) to the yielded list (the smear's canvas as a copy
    taken before the walk), then runs as before."""
    from coherence_tpu_torch.raster import brush

    calls, real = [], {name: getattr(brush, name) for name in ("_stamp_alpha", "_smear_walk")}

    def recording(name):
        def call(*args):
            calls.append((name, (args[0].clone(), *args[1:]) if name == "_smear_walk" else args))
            return real[name](*args)

        return call

    for name in real:
        setattr(brush, name, recording(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(brush, name, fn)


def replayed(program, name: str):
    """A thunk that calls raster/brush.py's `name` (_stamp_alpha or
    _smear_walk) with the arguments of the first such call that the thunk
    `program` makes, which its first call records (the smear walks its
    recorded canvas again each call)."""
    from coherence_tpu_torch.raster import brush

    recorded = []

    def call():
        if not recorded:
            with recorded_brush_calls() as calls:
                program()
            recorded.append(next(args for n, args in calls if n == name))
        return getattr(brush, name)(*recorded[0])

    return call


# A rebuild's parts: name -> (file, function, calling functions or None),
# read as the cProfile row's cumulative seconds (only the calls from the
# callers, where they are named: an older full_sprites_of_objects made the
# batched build's calls itself, _group_members makes them now, so both are
# named and a parent checkout splits alike).  Nested parts repeat their
# parents' seconds: the AA sweep runs inside _edge_spans' calls from
# scaled_spans_of_edgelist, not inside "sweep_1x".
SPLIT_PARTS = {
    "render": ("render.py", "render_simple_scene", None),
    "full_sprites_of_objects": ("fastframe.py", "full_sprites_of_objects", None),
    "sweep_1x": ("scanline.py", "_edge_spans", ("full_sprites_of_objects", "_group_members")),
    "sweep_aa": ("scanline.py", "scaled_spans_of_edgelist", ("full_sprites_of_objects", "_group_members")),
    "minshape_empty": ("fastframe.py", "_minshape_empty", None),
    "raster_members": ("fastframe.py", "_raster_members", None),
    "raster_members.spans_in": ("fastframe.py", "_spans_in", ("_raster_members",)),
    "raster_members.mask_of_spans": ("aa.py", "mask_of_spans", ("_batch_masks",)),
    "raster_members.coverage_counts": ("aa.py", "coverage_counts", ("_raster_members",)),
    "raster_members.dissolve": ("colour.py", "dissolve_rgba", ("_raster_members",)),
    "sprite_raster_members": ("fastframe.py", "_sprite_raster_members", None),
    "sprite_raster_lists": ("__init__.py", "sprite_raster_lists", None),
    "stage": ("staging.py", "stage", None),
    "sprite_raster": ("__init__.py", "sprite_raster", None),
    "scalar_members": ("fastframe.py", "full_sprite_of_object", ("full_sprites_of_objects", "_group_members")),
    "coverage_opacity": ("aa.py", "coverage_opacity", None),
    "polygon_sprite_edgelist": ("aa.py", "polygon_sprite_edgelist", None),
    "shape_of_basicshape": ("render.py", "shape_of_basicshape", None),
    "fold": ("framepath.py", "fold_layers_carry", None),
    "cache_seeding": ("cache.py", "addshape", ("full_sprites_of_objects",)),
}


def split_of(stats) -> dict:
    """SPLIT_PARTS' cumulative seconds and calls in a pstats.Stats, the
    parts with no call left out."""
    out = {}
    for part, (file, func, caller) in SPLIT_PARTS.items():
        seconds = calls = 0
        for (path, _, f), (_, nc, _, ct, callers) in stats.stats.items():
            if f != func or os.path.basename(path) != file:
                continue
            if caller is None:
                seconds, calls = seconds + ct, calls + nc
            else:
                for (_, _, cf), (_, cnc, _, cct) in callers.items():
                    if cf in caller:
                        seconds, calls = seconds + cct, calls + cnc
        if calls:
            out[part] = {"s": seconds, "calls": calls}
    return out


def rebuild_split(torch, out_dir: str, smi: str, reps: int = 3, dev: str = "cuda") -> dict:
    """The general_lion rebuild on the batched group route and on the
    per-member fold route: `reps` unprofiled rebuilds each (host seconds
    after a synchronize), then one of each under cProfile, split by
    split_of."""
    import chip_smoke as cs
    from profile_interactive import cprofiled, write_stats

    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import flags

    cs.fresh_cache()
    obj = cs.fitted_lion()
    shape = region.shape_of_box(cs.WINDOW, dev)

    def rebuild():
        cache.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R.render_simple_scene([obj], shape, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"nvidia_smi": smi}
    for route, batched in (("batched", True), ("fold", False)):
        flags.set_flag("batch_group_raster", batched)
        try:
            rebuild()  # first use on this route
            seconds = [rebuild() for _ in range(reps)]
            cache.clear()
            prof_s, stats = cprofiled(lambda: (R.render_simple_scene([obj], shape, dev), torch.cuda.synchronize()))
        finally:
            flags.set_flag("batch_group_raster", True)
        write_stats(os.path.join(out_dir, f"split_{route}.txt"), prof_s, stats)
        out[route] = {"s": seconds, "s_median": statistics.median(seconds), "profiled_s": prof_s,
                      "split": split_of(stats)}
    cache.clear()
    return out


SPLIT_MODULES = ("region", "convolve", "aa")  # raster/ modules whose outermost functions the filters split names


@contextlib.contextmanager
def outermost_split():
    """Inside, every torch operation dispatched and every hand-written
    kernel launched (kernels._raise_on, which each wrapper calls after its
    launch) is counted under the outermost function of SPLIT_MODULES on
    the Python stack ("module.function"), or "other".  Yields {"ops":
    {key: n}, "launches": {key: {kernel: n}}}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import aa, convolve, region

    files = {os.path.abspath(m.__file__): name for m, name in zip((region, convolve, aa), SPLIT_MODULES)}
    out = {"ops": {}, "launches": {}}

    def outermost(frame) -> str:
        key = "other"
        while frame is not None:
            name = files.get(os.path.abspath(frame.f_code.co_filename))
            if name is not None:
                key = f"{name}.{frame.f_code.co_name}"
            frame = frame.f_back
        return key

    class Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            key = outermost(sys._getframe(1))
            out["ops"][key] = out["ops"].get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    real = kernels._raise_on

    def counted(name, rc):
        real(name, rc)
        by = out["launches"].setdefault(outermost(sys._getframe(1)), {})
        by[name] = by.get(name, 0) + 1

    kernels._raise_on = counted
    try:
        with Counting():
            yield out
    finally:
        kernels._raise_on = real


def filters_split(torch, smi: str, dev: str = "cuda", split_frame: int = 3) -> dict:
    """general_filters' frames on `dev` as chip_smoke.filter_frames renders
    them: frame `split_frame`'s incremental render and the whole-window
    render after it split by outermost_split (with the syncs, ops and
    launches in all), frame split_frame + 1's both counted by `issued`."""
    import chip_smoke as cs

    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R

    lens, blob, objs = cs.filter_scene()
    cs.fresh_cache()
    master = region.shape_of_box(cs.WINDOW, dev)
    state = {"frame": R.render_simple_scene([lens, blob] + objs, master, dev), "blob": blob}
    out = {"nvidia_smi": smi, "frames": {"warm": split_frame, "split": split_frame, "issued": split_frame + 1}}

    def frame(k: int):
        """(incremental, whole) thunks of frame k."""
        moved = R.translate_renderobject(*cs.delta(k * 40), state["blob"])
        scene = [lens, moved] + objs

        def incremental():
            d = R.dirty_filter(moved.idset, R.dirty_region(state["blob"], moved, dev)(master), scene, dev)
            patch, _, _ = R.render_scene(moved.idset, False, (d, None), scene, scene, master, dev)
            state["frame"] = region.caf("over", "opaque", patch,
                                        region.portion(state["frame"], region.shape_difference(master, d)))[0]

        def whole():
            R.render_simple_scene(scene, master, dev)
            state["blob"] = moved

        return incremental, whole

    for k in range(split_frame):
        for fn in frame(k):
            fn()
    for part, fn in zip(("incremental", "whole"), frame(split_frame)):
        torch.cuda.synchronize()
        region.syncs = 0
        before = dict(kernels.launches)
        with outermost_split() as split:
            fn()
            torch.cuda.synchronize()
        out[part] = {"syncs": region.syncs, "ops_total": sum(split["ops"].values()),
                     "ops": dict(sorted(split["ops"].items(), key=lambda kv: -kv[1])), "launches": split["launches"],
                     "kernel_launches": {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                                         if v != before.get(k, 0)}}
    for part, fn in zip(("incremental", "whole"), frame(split_frame + 1)):
        out[part]["issued"] = issued(torch, fn)
    cache.clear()
    out["general_lion_issued"] = lion_issued(torch, dev)
    out["pdf_pages_issued"] = pdf_issued(torch, dev)
    return out


def lion_issued(torch, dev: str) -> dict:
    """The launches and copies issued by one general_lion rebuild on each
    route (the batched group route, the per-member fold route), after a
    first render on that route, as chip_smoke.general_lion counts them."""
    import chip_smoke as cs

    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import flags

    cs.fresh_cache()
    obj = cs.fitted_lion()
    shape = region.shape_of_box(cs.WINDOW, dev)
    render = lambda: R.render_simple_scene([obj], shape, dev)
    out = {}
    for route, batched in (("batched", True), ("fold_route", False)):
        flags.set_flag("batch_group_raster", batched)
        try:
            cache.clear()
            render()
            out[route] = cs.issued_rebuild(torch, render)
        finally:
            flags.set_flag("batch_group_raster", True)
    cache.clear()
    return out


def pdf_issued(torch, dev: str) -> int:
    """The launches and copies issued by the three pages of
    chip_smoke.pdf_document painted cold through an Engine on `dev`, after
    a first painting, as chip_smoke.pdf_pages counts them."""
    import tempfile

    import chip_smoke as cs

    from coherence_tpu_torch.gui import app
    from coherence_tpu_torch.gui import window as Wn
    from coherence_tpu_torch.io import pdf as P
    from coherence_tpu_torch.scene import cache

    pdf = P.Pdf(*cs.pdf_document(P, cs.W, cs.H))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pdf_pages.pdf")
        with open(path, "wb") as f:
            f.write(P.pdf_to_bytes(pdf))

        def all_pages():
            eng = app.Engine(device=dev)
            eng.event_handler((Wn.OPEN_FILE, path))
            view = eng.views[0]
            eng.render_rect(view.window, 0, 0, *cs.PDF_CANVAS)
            for page in (1, 2):
                eng.goto_page(view, page)
                eng.render_rect(view.window, 0, 0, *cs.PDF_CANVAS)

        cache.clear()
        all_pages()
        cache.clear()
        n = issued(torch, all_pages)
        cache.clear()
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_general", help="directory for the profile files")
    ap.add_argument("--split", action="store_true", help="only split the rebuild on both routes")
    ap.add_argument("--filters", action="store_true", help="only split general_filters' incremental frame and whole render")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_general: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from profile_interactive import cprofile_to

    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R

    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    if args.split:
        print(json.dumps(rebuild_split(torch, args.out, smi)))
        return 0
    if args.filters:
        print(json.dumps(filters_split(torch, smi)))
        return 0
    cs.fresh_cache()
    obj = cs.fitted_lion()
    shape = region.shape_of_box(cs.WINDOW, dev)
    render = lambda: R.render_simple_scene([obj], shape, dev)
    render()  # first-use set-up
    cache.clear()
    _, rebuild = cs.measured(torch, dev, render)
    _, warm = cs.measured(torch, dev, render)

    cache.clear()
    _, prof, ops, device_ms, seconds, issued = profiled(torch, render)
    with open(os.path.join(args.out, "rebuild_profile.txt"), "w") as f:
        f.write(f"{smi}\nprofiled_s {seconds} device_ms {device_ms} device_ops {ops} issued {issued}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    cache.clear()
    cprofile_s = cprofile_to(os.path.join(args.out, "rebuild_cprofile.txt"),
                             lambda: (render(), torch.cuda.synchronize()))

    table = {}
    lines = [smi]
    for name, (program, at, fn) in programs(torch, dev).items():
        fn()  # warm
        _, _, n_ops, ms, _, n_issued = profiled(torch, fn, reps=5)
        table[name] = {"jax_program": program, "shape": at, "device_ops": n_ops, "issued": n_issued, "device_ms": ms}
        lines.append(f"{name:24s} {n_ops:9.1f} device rows {n_issued:9.1f} issued {ms:9.4f} ms  {program}  [{at}]")
    with open(os.path.join(args.out, "programs.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    cache.clear()
    print(json.dumps({"nvidia_smi": smi, "rebuild_unprofiled": rebuild, "warm_unprofiled": warm,
                      "rebuild_profiled": {"device_ops": ops, "issued": issued, "device_ms": device_ms, "host_s": seconds,
                                           "device_share_of_unprofiled_host": device_ms / rebuild["host_ms"]},
                      "rebuild_cprofile_s": cprofile_s, "programs": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
