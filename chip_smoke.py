#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Five paths of the tile route run, each with the launch counters zeroed just
before it and read just after; then the general renderer (torch operations
on the card, each group folded by the fold_layers kernel); then the sprite
route, the scene edits and the device window path; then
the serving surface, a server in a thread and a display client on a real
localhost TCP socket, as a user of the system runs it:

  * the lion (bench.py) at 1920x1080: the lion's 132 paths rasterized into
    a 1024-slot tile atlas, a translucent crimson blob (r=60) reserved for
    in-place moves, a radius-5 Gaussian blur filter over the band F_BOX,
    then 400 animated frames dragging the blob by (7, 3) and back by
    (-7, -3) every 200 frames;
  * the interactive 4K scene (benchmarks/run.py config 5) at 3840x2160:
    1000 circles and rectangles and 6 Gaussian brush strokes in a
    4096-slot atlas, a crimson blob (r=70) under a radius-4 blur band; 200
    filtered frames, 200 plain frames, full-frame renders through
    composite_full and composite_runs, 4 zoom steps (2x and back about
    the frame centre, through the scene-build cache), then a prefetch of
    both zoom directions and a 0.5x step;
  * the dense layer stack (benchmarks/run.py config 2): 100 rectangles at
    1088x1920, composited over white by composite_layers;
  * config 5 on a 2-band mesh (two cards where there are two; with one
    card both bands share it): 200 filtered frames through the sharded
    step_animated, a full render through render_sharded and a zoom step,
    each against the unsharded view on the same card;
  * the lion on a 17-band mesh (one tile row per band, so most bands are
    idle every frame): a full render and 20 filtered frames against the
    unsharded lion;
  * the general renderer (render_simple_scene, render_scene, the coherence
    cache, the filters) at 1920x1080: the lion as one group fitted to 1024
    pixels (benchmarks/run.py config 1 at full size), cold, rebuilt and
    warm; the bench.py scene under a radius-5 filters.blur lens with the
    blob dragged beneath it for 10 frames, each frame the dirty region
    rendered over the last and the whole window rendered again; one render
    of each other filter demo over every fourth path of the lion; the 1088x1920 Gaussian blur
    (benchmarks/run.py config 4, 30 chained calls); assets/zoom.pdf (two
    stroked paths) through the tile route, and the five icon PDFs;
  * the sprite route and the scene edits at 1920x1080: the bench.py lion
    and blob rasterized by the batched raster into a DeviceView (its full
    render against the tile route's), then a circle added, a path
    recoloured, a path removed, a restack, the blob removed and re-added 50
    times and 500 boxes added, each frame against a fresh view of the
    edited scene; the tile build's scalar fallback; a FrameBuffer
    compositing them under the radius-5 blur with the blob dragged 20
    frames (recomposite_blur); the fold_layers kernel at the three shapes
    the program gives it: the lion's 132 sprites over the whole window,
    the lion group's fold over its update shape, one recomposite_blur
    window;
  * the serving surface at 1920x1080 (benchmarks/session.py's two
    sessions): a FastSession (the lion, a blob dragged under a radius-3
    blur lens, 8 + 100 drags, 11 small paints, a blur-slider sweep) and
    an Engine (first paint, a click that picks the blob, 8 + 40 drags, the
    slider over the selection, a rubberband zoom in and a right-click zoom
    out), each answering the port's HeadlessClient over the wire protocol;
  * a PDF document opened through the served Engine (OpenFile, then
    PageDown twice): a three-page file this script builds (pdf_document)
    and writes with the port's writer, MediaBox 1920x1080, page 1 every
    graphics construct of the port's reader (colour spaces, shadings,
    meshes, patterns, soft masks, transparency groups, blend modes, an
    annotation, optional content), page 2 images (a 1024x768 Flate RGB
    image, an Indexed image with an /SMask, a stencil, an inline and a
    CCITT G4 image), page 3 over 2,000 glyphs of text (text_page: a
    TrueType, a bare CFF and a Type 1 program the script writes itself,
    Type0 Identity-H and -V, a Type 3 font and Helvetica, render modes 0-3
    and 7, the spacing operators, a transparency group, a soft mask and a
    tiling cell holding text); the same file encrypted (AES-256, R6).

Phases, one JSON line each:

  1. device: the card's name, and nvidia-smi's name and power limit;
  2. build: the CUDA kernels compiled from the checkout's sources;
  3. kernels: composite_full and composite_dirty against their plain
     PyTorch versions on the lion's shapes, bit for bit; each also against
     its banded kernel over one band (banded_one_band: every kernel walks
     the same striped ring, stripe_ring.cuh); a deep case (a 301-piece
     translucent tile, a tile opaque at its first piece, an empty tile and
     a passthrough slot) through composite_full, composite_runs,
     composite_full_banded and composite_dirty, whose deep tile times one
     step of the first three in turns; the times (CUDA events, cold L2,
     the launch queued behind a device-side wait), each comparison's in
     turns with the kernel's, and the bytes each must move; then
     blur_blend (window mode, at the lion's blur window; rect mode, the
     whole frame) and shatter_into (the blob's pieces) against their plain
     versions on the inputs of one animated step, the display and the
     reserved slots starting from noise, each timed beside its plain
     version and its bound;
  4. main_path: the lion, built cold (the scene-build and sweep caches
     emptied before the CPU's build and before the card's, so that the card
     rasterizes its own atlas through tile_raster, held bit for bit against
     the CPU's) and run 400 frames; per-frame times; the
     display after 20 frames held bit for bit against the same 20 frames
     run on the CPU through the plain versions; one full-frame render held
     against the dirty-path content; three more frames, each required to
     issue exactly one copy and three launches (shatter_into,
     composite_dirty, blur_blend: the JAX package's one program),
     counted by profile_general.issued;
  5. interactive_4k: config 5 on the card; its atlas, piece lists and
     display after 3 filtered frames held bit for bit against the same run
     on the CPU; frame times, build and zoom seconds, cache hits; the full
     renders held against the dirty-path content; brush_stamp and
     tile_raster launched at the build and at each zoom step that misses
     the scene-build cache, never at a hit, tile_raster at the prefetch; the
     sweep cache's hits and misses of each zoom step;
  6. kernels_4k: composite_runs against composite_runs_torch and against
     composite_full, and composite_full against composite_full_banded over
     one band, on config 5's full-frame lists, bit for bit; the three timed
     in turns; blur_blend and shatter_into on config 5's animated step, as
     in phase 3; then brush_kernels: brush_stamp in plane mode (the
     general renderer's stamp walk at profile_general.py's 31x31 brush of
     1013 stamps, and a radius-120 brush), in piece mode (each of config
     5's brush groups as its scene build stages them, at 3840x2160 and
     after a 2x zoom) and smear_walk (profile_general.py's smear: 1024
     steps over its 711x611 sprite, two passes, in window mode; a
     radius-120 smear of 298 steps in global mode), each against its plain
     version on the same inputs, bit for bit, timed behind a device-side
     wait made from the wrapper's host time, beside its plain version's
     time, its bound and the launch floor (brush_stamp also alone on lists
     staged beforehand, beside its staged copy alone, its blocks and the
     longest and mean list a block reads; the smear also beside its chain
     floor, its mode and its window's reloads, as the kernel counted
     them; the demo must take window mode to its end, radius 120 global
     mode); then tile_kernels: tile_raster over the lion's and config 5's
     build flush (every block of TileBuild.batches() in one launch, staged
     as the build stages them) against the plain version on the card, bit
     for bit, timed with the lists staged beforehand behind a device-side
     wait, beside each class's block timed alone, the plain version's time,
     the wrapper's host time, the bound (the lists read once and every slot
     written once, or 1024 multiply-adds a fringe pixel), the bytes of the
     kernel's lists and the launch floor; one TileBuild.flush required to
     issue one copy and one launch; then sprite_kernels: sprite_raster in
     group mode over general_lion's 130 batched members (every group in one
     launch) and in opacity mode over each of its two scalar members'
     mattes and a 131,071 x 2 matte past the first design's packing (H61),
     against the plain versions on the card (_raster_members over each
     group's sub-batches, coverage_opacity_torch), bit for bit, every
     plane contiguous on 16 bytes; the kernel alone on lists staged
     beforehand, the staged copy alone, the plain version, the wrapper's
     host time, the spans a launch reads, the bound (the lists read once
     and the planes written once, or 1024 multiply-adds a fringe pixel; a
     matte's at its mixed pixels only, its every-pixel bound beside) and
     the launch floor; one call of
     each wrapper required to issue one copy and one launch; then
     region_kernels: caf (CF1), tight_bounds (TB1), box_morph (MR1) and
     convolve_canvas (CV1) at every call general_filters' whole-window
     render and first dragged frame make (recorded_region_calls), and CV1
     at config 4's frame, each against its plain version on the card
     (caf_torch, _tight_bounds_torch, dilate_torch and erode_torch,
     convolve_canvas_torch), bit for bit; then timed at the frames'
     shapes (caf: the last frame over a white 1920 x 1080 window, as
     frame_path composes it, the frames' largest caf of two operands and
     their median one; the largest and the median tight_bounds mask; each
     distinct bloat and erosion, and a synthetic bloat on box_morph's
     second route, MORPH_SECOND_ROUTE, checked bit for bit too; each
     convolve) beside the plain version, the launch floor, the bound (each
     read plane's 32-byte sectors, tensor_sectors, and the writes once; a
     convolve's multiply-adds beside), each box_morph row's route and, for
     a bloat, torch.nn.functional.max_pool2d's time over the same mask;
  7. hsr_layers: config 2's stack through composite_layers, then the
     kernel against composite_layers_torch over noise and over white, bit
     for bit, timed;
  8. mesh_4k: config 5 on 2 bands: the devices used, frame times of the
     meshed and the unsharded view (same call), the display held bit for
     bit at frame 3 and frame 200, no banded-atlas rebuild in the loop, the
     banded atlas's build seconds and per-band bytes against the global
     atlas, the zoom step against a fresh unsharded view;
  9. mesh_kernels: composite_full_banded and composite_dirty_banded against
     their plain versions and the unbanded kernels on config 5's 2-band
     lists (the dirty case with an idle band), bit for bit, each timed in
     turns with its unbanded kernel (composite_full on the same frame,
     composite_dirty on the same tiles);
 10. mesh_lion: the 17-band lion against the unsharded lion; then
     composite_dirty_banded on the lion's 17-band dirty lists of one band
     (16 idle bands) and composite_full_banded on its 17-band full-frame
     lists, bit for bit, each timed in turns with its unbanded kernel;
 11. play_animated: the lion's play_animated over 400 deltas against 400
     step_animated calls, with its time per frame; one play launches
     shatter_into, composite_dirty and blur_blend 400 times each and
     nothing else;
 12. animated_chain: the lion's steady step_animated and config 5's
     filtered frame with their launches queued ahead of the card (100
     frames behind one device-side wait, CUDA events from the wait's end to
     the last frame's, median of 5), where programmatic dependent launch
     starts composite_dirty as shatter_into ends and blur_blend as
     composite_dirty ends, each waiting on the card for the writes before
     it; after each rep the display and content equal,
     bit for bit, to a second scene's stepped one frame at a time, and
     every frame launching shatter_into, composite_dirty and blur_blend
     once each;
 13. dryrun: parallel.dryrun.dryrun_multichip(2) on the card;
 14. general_lion: the cold, rebuilt and warm renders (the lion group
     through the batched raster and one fold_layers launch) and one more
     rebuild through the per-member fold, all equal, and equal to the CPU's
     render of the same scene; per render the host and CUDA-event time, the
     objects the fold visited, its early exits, the host syncs counted in
     raster/region.py, the cache's bytes; per route of the rebuild the
     launches and copies issued (profile_general.py's count), the
     fold_layers and the sprite_raster launches (the batched route's
     required to be the routing's prediction: one for the batched members,
     one a scalar member's matte); the peak device memory;
 15. general_filters: every incremental frame equal to the whole-window
     render, frame 0 also to a render with the cache off, frames 0-1 to the
     CPU's; frame times; each of caf, tight_bounds, box_morph and
     convolve_canvas launched in the frames; the launches and copies
     issued by one steady incremental frame (frame 4 of a second run) and
     by the whole-window render after it, with the kernels launched in
     each; then general_filter_demos: monochrome, hole, rgb,
     affine, wireframe, smear, the CPG demo and the brush and monobrush
     demos over the lion, each equal to the CPU's and each changing the
     lion; the smear launches smear_walk and each brush demo brush_stamp
     (plane mode);
 16. convolve_1080p: ms per call beside its bound (the frame read and
     written once at 3.35 TB/s); the first call equal to the CPU's; two
     convolve_canvas (CV1) launches a call and no other launch;
 17. stroked_tiles: the frame, atlas and piece lists equal to the CPU's;
     each icon equal to the CPU's;
 18. scene_edits: the sprite route's full render (composite_full) equal to
     the tile route's and to the CPU's; after each edit the dirty render
     (composite_dirty) equal to a fresh view's full render of the edited
     scene, the first two also to the CPU's; the churn keeps the atlas's
     capacity and piece count; add_boxes equal to add_object of the same
     boxes; the fallback tile build equal to the sprite route; the edit
     times;
 19. frame_path: the frame times of recomposite_blur; frames 0-2 equal to
     the CPU's and to the general renderer's render of the same filtered
     scene; the last equal to a whole-window recomposite plus apply_blur;
     one blur_blend launch a frame and one for apply_blur;
 20. fold_kernel: fold_layers against fold_layers_carry_torch at three
     shapes, in one call and in two with the carry, bit for bit, the two
     timed in turns: the lion's 132 sprites over the 1920x1080 window (all
     open); the lion group's fold as general_lion's render calls it (the
     update shape's mask open); the last recomposite_blur window of
     frame_path (its prefiltered layer pack, inwin open); per shape the
     bytes it must move and the record visits its tile lists imply;
 21. serve_fast: what the client saw: seconds to the first paint, the drag
     latency (event sent to pixels landed; median and p95), the wire floor
     (a 2x2 paint's round trip), the slider latency, the bytes shipped and
     the host syncs per drag; one RefreshWindow and one composite_dirty
     launch per drag; the client's image equal to the server's display plane
     after the drags and after the slider, and equal to the client's image
     of the same session served from the CPU after 10 drags (the
     scene-build cache is emptied between the two, so the card rasterizes
     the scene itself); after the session, a full-frame render of its view
     (composite_full, which the session never launches) equal to its content;
 22. serve_engine: first paint, drag latency, slider latency, zoom in and
     out seconds, objects visited and host syncs per drag; the client's
     image equal to the engine's framebuffer after every stage, and equal
     to the client's image of an Engine on the CPU after the first paint,
     the pick and each of the first 3 drags.  The loop runs with
     containment off: a handler's exception ends the phase;
 23. pdf_pages: the document opened and its pages turned on the CPU, then
     on the card (both caches emptied between): the client's image and the
     engine's 1280x1024 framebuffer of each page equal, bit for bit, page 3
     unlike pages 1 and 2; first paint and the two page turns' seconds at
     the client, host syncs, objects visited, the launches and copies
     issued for the three pages painted cold (profile_general.py's count),
     the fold_layers launches per page (at least one on page 3: its group
     of text), no tile kernel; the encrypted file through a second served
     Engine on the card, its three framebuffers equal to the plain file's,
     and its open-to-first-paint seconds; page 3 rendered once with
     render.pdf_debug_active on the CPU and on the card, the two debug
     PDFs equal byte for byte and one of their pages imaging a fragment;
     the glyphs painted, both files' bytes, the fallback face for
     Helvetica (or null); the phase's share of the run.

Then the script's seconds from the first phase to here, the kernels line (per kernel: its launches on the main path, its
time, its plain version's, its bound from the bytes it must move at 3.35
TB/s, counted per 32-byte sector: the pieces each sector reads until its
pixels are opaque, its background where it stays translucent, its write;
and the share of that bound, beside the per-stripe count; the time of
each comparison timed in turns: composite_full's and composite_dirty's
banded_one_band, composite_runs's composite_full on the same lists, the
banded kernels' unbanded ones, also on the 17-band lion; for fold_layers
the mask and RGBA sectors each open pixel reads until it closes, and its
carry in and out, with the record visits its tile lists imply, at the
whole window and beside it at its other two shapes; its launches per
phase, pdf_pages's among them; for blur_blend and shatter_into the bytes
they must move per 32-byte sector and their multiply-adds, at the lion's
step and at config 5's, blur_blend's rect mode beside, and under
shatter_into the animated_chain's time per queued frame; for brush_stamp
its output and lists' bytes and its stamp-pixel operations at config 5's
largest brush group, every other shape beside, its time with its staged
copy (ms) and alone (kernel_ms); for smear_walk the canvas
pixels its walk must read and write once and its mixed-pixel operations,
beside them its step-by-step traffic, a serial chain of steps, the chain's
floor at one SM's int32 rate, its mode, window and reloads as the kernel
counted them, and the radius-120 smear in global mode; for tile_raster
the bytes of its lists and slots and its fringe multiply-adds at the lion's
build flush, config 5's beside, its launches (one a flush) at the lion's
build, config 5's build, each zoom step and the prefetch; for
sprite_raster the same at general_lion's batched members, each scalar
matte and the H61 matte beside, its launches in the rebuild, on the fold route, in the
filter frames and demos, serve_engine and pdf_pages; for caf, tight_bounds,
box_morph and convolve_canvas the largest shape's row of region_kernels
(a bloat's for box_morph, beside max_pool2d's time), every shape beside
(the synthetic one too), caf's and box_morph's registers and static
shared memory from the build's ptxas lines (ptxas_info),
the calls checked, the launches in general_filters' frames and per steady
incremental frame with the frame's issued operations, in general_lion's
rebuild on each route, the demos, convolve_1080p, scene_edits,
serve_engine and pdf_pages) and, last,
{"ok": true, "device": {...}}.  Any mismatch or exception ends the
run with a nonzero exit code, as does an import of JAX or of the JAX
package.
"""

import contextlib
import gc
import json
import re
import socket
import statistics
import subprocess
import sys
import threading
import time

W, H = 1920, 1080
BLUR_RADIUS = 5
F_BOX = (40, 320, 1680, 1060)
ATLAS_CAP = 1024
N_FRAMES = 400
N_CHECK = 20
N_TIMED = 25

# The interactive 4K scene (benchmarks/run.py config 5).
W4, H4 = 3840, 2160
BLUR4 = 4
ATLAS_CAP4 = 4096
N_FRAMES4 = 200
N_ZOOMS = 4
# The dense layer stack (benchmarks/run.py config 2).
HSR_K, HSR_H, HSR_W = 100, 1088, 1920

CSRC = "coherence_tpu_torch/kernels/csrc/"
SOURCE = CSRC + "tile_composite.cu"

# A kernel's bound: the bytes it must move over the H100 SXM's HBM rate
# (NVIDIA's data sheet).  Every compositor is bound by bytes, counted per
# 32-byte sector (8 pixels), the least the memory moves.
HBM_BYTES_PER_S = 3.35e12
PIECE_BYTES = 64 * 128 * 4
SECTOR_BYTES = 32
STRIPES = 16  # 4-row stripes of a tile, stripe_ring.cuh's kStripes
# The device-side wait queued before each timed launch: about 0.2 ms at the
# H100's 1.98 GHz boost clock, longer than a wrapper takes to queue its
# launch, so the timed window opens on a launch already queued.  A wrapper
# with more host work (the fold's packs every layer) is timed behind a wait
# made from its measured host time instead (event_ms's wait_ms).
SLEEP_CYCLES = 400_000
# The blur's bound counts its 32-bit integer multiply-adds too (two
# operations each) at the H100 SXM's int32 rate: the CUDA C++ Programming
# Guide's throughput table gives compute capability 9.0 64 integer
# multiply-adds a clock per SM against 128 float32 FMAs, so half the
# guide's CUDA-core float32 peak of 67 T/s.
INT_OPS_PER_S = 67e12 / 2
# The H100 SXM's streaming multiprocessors: a chain of dependent steps on
# one block runs on one of them, at its share of INT_OPS_PER_S at most.
SMS = 132
# The device-side wait before each timed blur_blend or shatter_into call:
# longer than twice either wrapper's host time (H42).
ANIMATED_WAIT_MS = 1.0
# A steady animated frame on the card: the staged copy of its lists, then
# shatter_into, composite_dirty and blur_blend (profile_general.issued's count).
STEADY_FRAME_OPS = 4
# The brush kernels' plain versions run one step of torch operations a
# stamp (about ten launches each, thousands of stamps): timed over fewer calls.
N_BRUSH_PLAIN_TIMED = 3
# The int32 operations of one stamp-pixel update, prelerp(p, t) =
# p + t - (((a >> 8) + a) >> 8) with a = t * p + 128: a multiply, four
# adds and two shifts.
STAMP_OPS = 7
# The int32 operations of one channel of a mixed smear pixel (0 < al < 255),
# dissolve(dst, al) + dissolve(src, 255 - al) with dissolve(c, d) =
# div255(c * d) and div255(i) = (i + (i >> 8) + 1) >> 8: two multiplies,
# five adds and four shifts.
SMEAR_OPS = 11


T_IMPORT = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (at_s, seconds
    since the script started), so that each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_IMPORT, 3)}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def build_scene(device, mesh=None):
    """The bench.py scene on `device`, through the port's entry points,
    split over `mesh` if one is given.  Returns (view, display, blob_key)."""
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import examples, fastframe

    objs, blob, f_geom = examples.bench_scene(W, H, blob_radius=60, blob_at=(120, 400), f_box=F_BOX)
    view = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=device)
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = fastframe.tiled_sprite_of_object(blob, view.pw, view.ph, device)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    if mesh is not None:
        view.use_mesh(mesh)
    f_alpha = fastframe.alpha_plane_of_object(f_geom, W, H, device)
    disp = fastframe.FilteredDisplay(view, f_alpha, convolve.mkgaussian(BLUR_RADIUS))
    disp.full_refresh()
    return view, disp, blob.idset


def delta(k: int):
    return (7, 3) if (k // 200) % 2 == 0 else (-7, -3)


def build_interactive(device, mesh=None):
    """Config 5 on `device`, through the port's entry points, as run.py
    builds it, split over `mesh` if one is given.  Returns (view, display,
    blob_key, objects)."""
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import examples, fastframe

    objs, blob, f_geom = examples.interactive_4k_scene(W4, H4)
    view = fastframe.DeviceView(W4, H4, atlas_cap=ATLAS_CAP4, device=device)
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = fastframe.tiled_sprite_of_object(blob, view.pw, view.ph, device)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    if mesh is not None:
        view.use_mesh(mesh)
    disp = fastframe.FilteredDisplay(view, fastframe.alpha_plane_of_object(f_geom, W4, H4, device),
                                     convolve.mkgaussian(BLUR4))
    disp.full_refresh()
    return view, disp, blob.idset, objs


def delta4(k: int):
    return (9, 4) if (k // 100) % 2 == 0 else (-9, -4)


def filtered_frame(view, disp, key, k: int) -> None:
    """run.py config 5's filtered frame: move the blob, refresh the display."""
    from coherence_tpu_torch.raster import region

    prev = view.sprites[key].box
    view.translate_object(key, *delta4(k))
    disp.step(region.box_union(prev, view.sprites[key].box))


def plain_frame(view, key, k: int) -> None:
    view.translate_object(key, *delta4(k))
    view.render()


def zoomed(objs, f: float):
    """The scene scaled by `f` about the 4K frame's centre, as a zoom step
    makes it."""
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    tmat = fastframe.zoom_transform(W4 / 2.0, H4 / 2.0, f)
    return [R.transform_renderobject_many(tmat, o) for o in objs]


def timed_frames(torch, fn, n: int):
    """(per-frame CUDA-event ms, host seconds) of fn(k) for k < n."""
    events = []
    t0 = time.perf_counter()
    for k in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(k)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [e0.elapsed_time(e1) for e0, e1 in events], time.perf_counter() - t0


def frame_stats(ms):
    steady = sorted(ms[1:])
    return {"first_ms": ms[0], "median_ms": statistics.median(steady),
            "p95_ms": steady[int(0.95 * (len(steady) - 1))]}


def scene_state(view):
    return view.ts.atlas().cpu().clone(), [list(view.ts.pieces[k]) for k in view.order]


_CYCLES_PER_MS = {}
# Readings that event_ms took again because the call outlasted half its wait on the host.
RETAKEN = [0]


def sleep_cycles_per_ms(torch) -> float:
    """torch.cuda._sleep's cycles per millisecond on the current card: waits
    of SLEEP_CYCLES timed with CUDA events, median of 5 (once a run)."""
    if "rate" not in _CYCLES_PER_MS:
        ms = []
        for _ in range(5):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            torch.cuda._sleep(SLEEP_CYCLES)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        _CYCLES_PER_MS["rate"] = SLEEP_CYCLES / statistics.median(ms)
    return _CYCLES_PER_MS["rate"]


def event_ms(torch, fn, scrub, reps: int = N_TIMED, wait_ms=None, queued: bool = False):
    """Median CUDA-event time (ms) of `reps` calls of fn, each after
    `scrub` (a buffer larger than the 50 MB L2) is overwritten, so every
    call starts with a cold L2 as a once-per-frame caller would.  A
    device-side wait sits between the scrub and the start event
    (SLEEP_CYCLES, or `wait_ms` at sleep_cycles_per_ms's rate), so fn's
    launches are queued before the window opens and the window holds the
    device work alone (a plain version that synchronizes inside still shows
    its host time).  With `queued` a call of fn that does not return on the
    host within half the wait is timed again (its host time would be in the
    window; counted in RETAKEN), and more than reps // 5 such calls raise
    RuntimeError: the wait is too short for this host.  The collector is off
    meanwhile, so that a collection is not such a call."""
    cycles = SLEEP_CYCLES if wait_ms is None else int(wait_ms * sleep_cycles_per_ms(torch))
    limit_ms = cycles / sleep_cycles_per_ms(torch) / 2 if queued else None
    times, slow = [], 0
    collecting = gc.isenabled()
    if queued:
        gc.collect()
        gc.disable()
    try:
        while len(times) < reps:
            scrub.zero_()
            torch.cuda._sleep(cycles)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            e1.record()
            e1.synchronize()
            if limit_ms is not None and host_ms >= limit_ms:
                slow += 1
                RETAKEN[0] += 1
                require(slow <= reps // 5, f"{slow} calls outlasted half of their {2 * limit_ms:.3f} ms wait on the "
                        f"host (the last {host_ms:.3f} ms)")
                continue
            times.append(e0.elapsed_time(e1))
    finally:
        if collecting:
            gc.enable()
    return statistics.median(times)


def in_turns(torch, new, scrub, wait_ms=None, **others):
    """{"ms", name + "_ms" for each of `others`, "readings"}: `new` and the
    functions of `others` (name -> fn) timed with event_ms in turns: the
    others in order, new twice, the others in reverse (old, new, new, old
    for one other); each time the mean of its two readings, "readings"
    every reading in that order.  With `wait_ms` every call waits that
    long, and each of new's calls must be queued within half of it."""
    order = [*others, None, None, *reversed(others)]
    readings = [event_ms(torch, new if name is None else others[name], scrub, wait_ms=wait_ms,
                         queued=wait_ms is not None and name is None)
                for name in order]
    mean = {name: statistics.mean(r for n, r in zip(order, readings) if n == name) for name in order}
    return {"ms": mean[None], **{f"{name}_ms": mean[name] for name in others}, "readings": readings}


def walked_depths(torch, atlas, idxs, spans):
    """(reads, still_open): for row t of `spans` (an (n, 2) int64 tensor of
    [lo, hi) ranges of `idxs`) and each of the tile's 1024 32-byte sectors
    (8 pixels of a row), the pieces the sector must read: up to and
    including the piece after which its 8 pixels are opaque, else hi - lo;
    and whether the sector is still translucent after them (only then does
    the `over` onto the background read it).  The accumulated alpha follows
    over_packed's alpha exactly, and stays 255 once it is 255."""
    n = spans[:, 1] - spans[:, 0]
    flat = atlas.reshape(atlas.shape[0], -1)
    n_sectors = flat.shape[1] * 4 // SECTOR_BYTES
    reads = torch.zeros((spans.shape[0], n_sectors), dtype=torch.int64, device=atlas.device)
    still_open = torch.ones((spans.shape[0], n_sectors), dtype=torch.bool, device=atlas.device)
    acc = torch.zeros((spans.shape[0], flat.shape[1]), dtype=torch.int32, device=atlas.device)
    for k in range(int(n.max()) if n.numel() else 0):
        rows = ((k < n) & still_open.any(1)).nonzero().squeeze(1)
        if rows.numel() == 0:
            break
        reads[rows] += still_open[rows]
        la = (flat[idxs[spans[rows, 0] + k].long()] >> 24) & 0xFF
        t = acc[rows] * la + 128
        a = la + acc[rows] - (((t >> 8) + t) >> 8)
        acc[rows] = a
        still_open[rows] = ~(a == 255).view(rows.numel(), n_sectors, -1).all(2)
    return reads, still_open


def layer_walk(torch, stack):
    """(reads, still_open) of a (K, H, W) layer stack in walked_depths's
    form, one row per 64x128 tile (tile-major) of its 1024 32-byte sectors:
    the layers each sector walks, down to the layer after which its 8
    pixels are opaque, else all K (over_packed's alpha, exactly), and
    whether the sector is still translucent after them."""
    k_layers, h, w = stack.shape
    acc = torch.zeros((h, w), dtype=torch.int32, device=stack.device)
    reads = torch.zeros((h, w // 8), dtype=torch.int64, device=stack.device)
    still_open = torch.ones_like(reads, dtype=torch.bool)
    for k in range(k_layers):
        reads += still_open
        la = (stack[k] >> 24) & 0xFF
        t = acc * la + 128
        acc = la + acc - (((t >> 8) + t) >> 8)
        still_open = ~(acc == 255).view(h, w // 8, 8).all(2)
    return tuple(x.view(h // 64, 64, w // 128, 16).permute(0, 2, 1, 3).reshape(-1, 1024) for x in (reads, still_open))


def full_spans(torch, starts):
    """The (n, 2) spans of every tile of a full-frame list."""
    return torch.stack([starts[:-1], starts[1:]], 1).long()


def dirty_spans(torch, coords, spans, n_slots: int, device):
    """The (n, 2) spans of the distinct real tiles of a dirty list (host
    arrays): passthrough slots and padding repeats left out."""
    real = {}
    for j in range(n_slots):
        if spans[2 * j] >= 0:
            real[(int(coords[2 * j]), int(coords[2 * j + 1]))] = (int(spans[2 * j]), int(spans[2 * j + 1]))
    return torch.tensor(sorted(real.values()), dtype=torch.int64, device=device).reshape(-1, 2)


def bound(walks) -> dict:
    """The bytes a compositor must move for the tiles of `walks`, a list of
    walked_depths results: each sector's walked pieces read once, its
    background read where it is still translucent, and every sector written
    once; and the time they take at the HBM rate.  `depth` is the deepest
    walk of any tile.  Two coarser counts stand beside it: every tile's
    pieces until the whole tile is opaque, its background and its write
    (`tile_count_bytes`, the first kernels' count), and the same per 4-row stripe
    (`stripe_count_bytes`, what a walk that stops each stripe on its own
    vote reads at least)."""
    tiles = sum(r.shape[0] for r, _ in walks)
    sector_reads = sum(int(r.sum()) for r, _ in walks)
    n_bytes = (sector_reads + sum(int(o.sum()) for _, o in walks) + sum(r.numel() for r, _ in walks)) * SECTOR_BYTES
    tile_pieces = sum(int(r.max(1).values.sum()) for r, _ in walks)
    stripe_pieces = sum(int(r.view(r.shape[0], STRIPES, -1).max(2).values.sum()) for r, _ in walks)
    return {"tiles": tiles, "piece_reads": sector_reads * SECTOR_BYTES / PIECE_BYTES,
            "depth": max(int(r.max()) for r, _ in walks), "bytes": n_bytes,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "tile_count_bytes": (tile_pieces + 2 * tiles) * PIECE_BYTES,
            "stripe_count_bytes": (stripe_pieces + 2 * tiles * STRIPES) * PIECE_BYTES // STRIPES}


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def with_passthrough(coords, spans, n_real: int, tile):
    """The dirty slot arrays with a passthrough slot (span -1) for `tile`
    put first, re-padded by repeating the last real slot."""
    import numpy as np

    n = n_real + 1
    n_slots = 8
    while n_slots < n:
        n_slots *= 2
    c = np.zeros(2 * n_slots, np.int32)
    s = np.zeros(2 * n_slots, np.int32)
    c[0:2] = tile
    s[0:2] = -1
    c[2 : 2 * n] = coords[: 2 * n_real]
    s[2 : 2 * n] = spans[: 2 * n_real]
    c[2 * n :: 2], c[2 * n + 1 :: 2] = c[2 * n - 2], c[2 * n - 1]
    s[2 * n :: 2], s[2 * n + 1 :: 2] = s[2 * n - 2], s[2 * n - 1]
    return c, s, n_slots


def uncounted(kernels, fn):
    """fn(), its launches taken off the counts again: a comparison of a
    kernel with its plain version is not a launch of the path."""
    before = dict(kernels.launches)
    out = fn()
    kernels.launches.update(before)
    return out


def zero_counts(torch, kernels) -> None:
    for k in kernels.launches:
        kernels.launches[k] = 0
    torch.cuda.synchronize()


def one_band(t):
    """A leading-dimension-1 view: one band of the banded kernels."""
    return t.view(1, *t.shape)


def deep_case(torch, dev, scrub):
    """The list kernels against their plain versions on a deep case: in a
    1x3 tile frame, tile 0 lists 301 translucent pieces (alpha 0..3, a span
    that no ring depth of 2, 4, 6 or 8 divides), tile 1 lists six pieces of
    which the first is opaque, tile 2 lists none in the full-frame lists
    and is a passthrough slot of the dirty list.  composite_full,
    composite_runs (over the runs gathered from the same list) and
    composite_full_banded over one band must agree; tile 0's walk then
    times one step of each, over that tile alone, in turns, per piece.
    Returns what the phase line reports."""
    from coherence_tpu_torch.raster import tiled_scene as T

    g = torch.Generator(device=dev).manual_seed(3)
    cap = 320
    alpha = torch.randint(0, 4, (cap, 64, 128), generator=g, device=dev, dtype=torch.int32)
    alpha[301] = 255
    rgb = [torch.minimum(torch.randint(0, 256, (cap, 64, 128), generator=g, device=dev, dtype=torch.int32), alpha)
           for _ in range(3)]
    atlas = rgb[0] | (rgb[1] << 8) | (rgb[2] << 16) | (alpha << 24)
    bg = torch.randint(-(2**31), 2**31 - 1, (64, 3 * 128), generator=g, device=dev, dtype=torch.int32)
    idxs = torch.zeros(512, dtype=torch.int32, device=dev)
    idxs[:301] = torch.arange(301, device=dev, dtype=torch.int32)
    idxs[301:307] = torch.tensor([301, 0, 1, 2, 3, 4], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 301, 307, 307], dtype=torch.int32, device=dev)
    full_k = T.composite_full(starts, idxs, bg, atlas, 1, 3)
    require(torch.equal(full_k, T.composite_full_torch(starts, idxs, bg, atlas, 1, 3)),
            "composite_full differs from composite_full_torch on the deep case")
    runs = T.gather_runs(atlas, idxs)
    runs_k = T.composite_runs(starts, bg, runs, 1, 3)
    banded = (one_band(starts), one_band(idxs), bg, one_band(atlas), 1, 3)
    banded_k = T.composite_full_banded(*banded)
    require(torch.equal(runs_k, T.composite_runs_torch(starts, bg, runs, 1, 3)),
            "composite_runs differs from composite_runs_torch on the deep case")
    require(torch.equal(banded_k, T.composite_full_banded_torch(*banded)),
            "composite_full_banded differs from composite_full_banded_torch on the deep case")
    require(torch.equal(runs_k, full_k), "composite_runs differs from composite_full on the deep case")
    require(torch.equal(banded_k, full_k), "composite_full_banded differs from composite_full on the deep case")
    require(torch.equal(full_k[:, 256:], bg[:, 256:]), "composite_full changed the empty tile's background")
    n_slots = 8
    coords = torch.tensor([0, 0, 0, 1, 0, 2] + [0, 2] * 5, dtype=torch.int32, device=dev)
    spans = torch.tensor([0, 301, 301, 307, -1, -1] + [-1, -1] * 5, dtype=torch.int32, device=dev)
    frame_k = torch.randint(-(2**31), 2**31 - 1, bg.shape, generator=g, device=dev, dtype=torch.int32)
    frame_p = frame_k.clone()
    T.composite_dirty(coords, spans, idxs, bg, frame_k, atlas, n_slots)
    T.composite_dirty_torch(coords, spans, idxs, bg, frame_p, atlas, n_slots)
    torch.cuda.synchronize()
    require(torch.equal(frame_k, frame_p), "composite_dirty differs from composite_dirty_torch on the deep case")
    require(torch.equal(frame_k[:, :256], full_k[:, :256]), "composite_dirty differs from composite_full")
    reads, _ = walked_depths(torch, atlas, idxs, full_spans(torch, starts[:3]))
    walked = [sorted(set(r)) for r in reads.tolist()]
    require(walked == [[301], [1]], f"deep case walks {walked}, expected every sector [[301], [1]]")
    s0, bg0 = starts[:2].clone(), bg[:, :128].contiguous()
    runs0 = T.gather_runs(atlas, idxs[:301])
    turns = in_turns(torch, lambda: T.composite_full(s0, idxs, bg0, atlas, 1, 1), scrub,
                     banded_one_band=lambda: T.composite_full_banded(one_band(s0), one_band(idxs), bg0,
                                                                     one_band(atlas), 1, 1),
                     composite_runs=lambda: T.composite_runs(s0, bg0, runs0, 1, 1))
    return {"equal_plain": True, "equal_composite_full": True, "tile_pieces": [301, 6, 0],
            "walked": [w[0] for w in walked], "passthrough_tile": 2, "deep_tile_ms": turns["ms"],
            "deep_tile_banded_one_band_ms": turns["banded_one_band_ms"],
            "deep_tile_composite_runs_ms": turns["composite_runs_ms"], "step_us": turns["ms"] / 301 * 1e3,
            "banded_one_band_step_us": turns["banded_one_band_ms"] / 301 * 1e3,
            "composite_runs_step_us": turns["composite_runs_ms"] / 301 * 1e3}


def pixel_sectors(torch, mask, row0: int, col0: int, row_pixels: int, pixel_bytes: int) -> int:
    """32-byte sectors holding the pixels of `mask` (a 2D bool block at
    (row0, col0) of a row-major plane)."""
    ys, xs = mask.nonzero(as_tuple=True)
    flat = ((ys + row0) * row_pixels + xs + col0) * pixel_bytes // SECTOR_BYTES
    return int(torch.unique(flat).numel())


def dilated(torch, mask, ry: int, rx: int):
    """`mask` grown by ry rows and rx columns (a box window)."""
    pooled = torch.nn.functional.max_pool2d(mask[None, None].float(), (2 * ry + 1, 2 * rx + 1), stride=1,
                                            padding=(ry, rx))
    return pooled[0, 0] > 0


def blur_bound(torch, f_alpha, content_cols: int, oy, ox, ry0, rx0, h, w, d_box, hb, wb, radius: int,
               rect: bool = False) -> dict:
    """What blur_blend must do for one window (or, with `rect`, the whole
    frame): the bytes (per 32-byte sector) of the packed content it reads
    (the 2r + 1 square around each written pixel), of the alpha plane it
    must test (bloat(in_d, r) inside the window; the whole frame in rect
    mode), and of the 16-byte pixels it writes (the changed ones; every
    pixel in rect mode, the others copied); and its multiply-adds: 4
    channels x (2r + 1) taps for each x-pass value the y pass reads and for
    each written pixel.  The bound is the larger of bytes at the HBM rate
    and operations at INT_OPS_PER_S."""
    dev = f_alpha.device
    rows = torch.arange(hb, device=dev)[:, None]
    cols = torch.arange(wb, device=dev)[None, :]
    fa = f_alpha[oy : oy + hb, ox : ox + wb]
    if rect:
        changed = fa > 0
        tested = torch.ones_like(changed)
    else:
        d0, d1, d2, d3 = (int(v) for v in d_box)
        inwin = (rows >= ry0) & (rows < ry0 + h) & (cols >= rx0) & (cols < rx0 + w)
        in_blur = (rows >= d0 - radius) & (rows <= d2 + radius) & (cols >= d1 - radius) & (cols <= d3 + radius)
        in_d = (rows >= d0) & (rows <= d2) & (cols >= d1) & (cols <= d3)
        changed = (in_d | (in_blur & (fa > 0))) & inwin
        tested = in_blur & inwin
    x_values = dilated(torch, changed, radius, 0)
    read = dilated(torch, x_values, 0, radius) | (tested if rect else changed)
    alpha_w = f_alpha.shape[1]
    written = tested if rect else changed
    sectors = (pixel_sectors(torch, read, oy, ox, content_cols, 4) + pixel_sectors(torch, tested, oy, ox, alpha_w, 4)
               + pixel_sectors(torch, written, oy, ox, alpha_w, 16))
    n_bytes = sectors * SECTOR_BYTES
    ops = 2 * 4 * (2 * radius + 1) * (int(x_values.sum()) + int(changed.sum()))
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"window": [hb, wb], "radius": radius, "changed_pixels": int(changed.sum()), "bytes": n_bytes,
            "operations": ops, "bound_ms": max(byte_ms, ops_ms), "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}


def shatter_bound(torch, rgba, oys, oxs) -> dict:
    """What shatter_into must move: every listed piece written whole (the
    padding repeats too), and each raster pixel under a piece read once (16
    bytes, per 32-byte sector)."""
    hs, ws = rgba.shape[:2]
    covered = torch.zeros((hs, ws), dtype=torch.bool)
    for oy, ox in zip(oys.reshape(-1).tolist(), oxs.reshape(-1).tolist()):
        covered[max(0, oy) : max(0, oy + 64), max(0, ox) : max(0, ox + 128)] = True
    n = int(oys.size)
    n_bytes = n * PIECE_BYTES + pixel_sectors(torch, covered, 0, 0, ws, 16) * SECTOR_BYTES
    return {"pieces": n, "raster": [hs, ws], "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def animated_kernels(torch, dev, view, disp, key, step, scrub) -> dict:
    """blur_blend (window mode) and shatter_into against their plain
    versions, bit for bit, on the inputs of one animated step of `key` by
    `step` (its blur window over the view's content, packed as
    FilteredDisplay blurs it and, as unpacked_ms, unpacked as FrameBuffer
    does; its moved raster into a copy of the atlas), each timed with the
    launch queued behind a
    device-side wait (ANIMATED_WAIT_MS, each call required to be queued
    within half of it), beside its plain version's time and its bound;
    and the launch floor (launch_floor_ms), an empty kernel launched
    through the same ctypes path and timed the same way.  The display and
    the reserved slots start from noise, so that every written value is
    checked.  Returns {name: row, "launch_floor_ms": ms}."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import framepath, staging
    from coherence_tpu_torch.raster import tiled_scene as T
    from coherence_tpu_torch.raster.compositor import unpack_rgba
    from coherence_tpu_torch.scene import fastframe

    moved, (oys, oxs, base), _, win, _ = disp.stage_animated(key, *step)
    require(win is not None, "the animated step has no blur window")
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    k = disp.kernel
    gen = torch.Generator(device=dev).manual_seed(5)
    noise = torch.randint(0, 256, tuple(disp.rgba.shape), generator=gen, device=dev, dtype=torch.int32)
    dk, dp = noise.clone(), noise.clone()

    def blur_kernel():
        fastframe.blur_blend_window(dk, view.frame, disp.f_alpha, oy, ox, ry0, rx0, h, w, d_box, hb, wb, k.values,
                                    k.total)

    def blur_plain():
        framepath.blur_blend_into_torch(dp, view.frame, (oy, ox), disp.f_alpha, (oy, ox), hb, wb, ry0, rx0, h, w,
                                        d_box, k.values, k.total)

    # FrameBuffer's form: the same window's content unpacked (16 bytes a pixel, not 4).
    window = unpack_rgba(view.frame[oy : oy + hb, ox : ox + wb])
    du = noise.clone()

    def blur_unpacked():
        framepath.blur_blend_into(du, window, (0, 0), disp.f_alpha, (oy, ox), hb, wb, ry0, rx0, h, w, d_box, k.values,
                                  k.total)

    atlas = view.ts.atlas()
    n = len(oys)
    ak, ap = atlas.clone(), atlas.clone()
    slot_noise = torch.randint(-(2**31), 2**31 - 1, (n, 64, 128), generator=gen, device=dev, dtype=torch.int32)
    ak[base : base + n] = slot_noise
    ap[base : base + n] = slot_noise
    oys_d, oxs_d = staging.stage(dev, oys, oxs)

    def shatter_kernel():
        T.shatter_into(ak, moved.rgba, oys_d, oxs_d, base)

    def shatter_plain():
        T.shatter_into_torch(ap, moved.rgba, oys_d, oxs_d, base)

    for fn in (blur_kernel, blur_plain, blur_unpacked, shatter_kernel, shatter_plain):
        fn()
    torch.cuda.synchronize()
    require(torch.equal(dk, dp), "blur_blend differs from blur_blend_into_torch")
    require(torch.equal(du, dp), "blur_blend over the unpacked window differs from blur_blend_into_torch")
    require(not torch.equal(dk, noise), "blur_blend wrote no pixel")
    require(torch.equal(ak, ap), "shatter_into differs from shatter_into_torch")
    require(not torch.equal(ak[base : base + n], slot_noise), "shatter_into wrote no piece")
    blur = {"max_abs_err": max_abs_err(dk, dp), **blur_bound(torch, disp.f_alpha, view.frame.shape[1], oy, ox, ry0,
                                                              rx0, h, w, d_box, hb, wb, k.radius),
            "ms": event_ms(torch, blur_kernel, scrub, wait_ms=ANIMATED_WAIT_MS, queued=True),
            "plain_ms": event_ms(torch, blur_plain, scrub),
            "unpacked_ms": event_ms(torch, blur_unpacked, scrub, wait_ms=ANIMATED_WAIT_MS, queued=True)}
    shatter = {"max_abs_err": max_abs_err(ak, ap), "base": base,
               **shatter_bound(torch, moved.rgba, oys, oxs),
               "ms": event_ms(torch, shatter_kernel, scrub, wait_ms=ANIMATED_WAIT_MS, queued=True),
               "plain_ms": event_ms(torch, shatter_plain, scrub)}
    for row in (blur, shatter):
        row["share"] = row["bound_ms"] / row["ms"]
    floor_ms = event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=ANIMATED_WAIT_MS, queued=True)
    return {"blur_blend": blur, "shatter_into": shatter, "launch_floor_ms": floor_ms}


def blur_rect_row(torch, dev, view, disp, scrub) -> dict:
    """blur_blend in rect mode (the full refresh) against its plain version
    over the whole frame, bit for bit, each timed, with its bound."""
    from coherence_tpu_torch.raster import framepath
    from coherence_tpu_torch.raster.compositor import unpack_rgba

    k, content, fa = disp.kernel, view.frame, disp.f_alpha
    height, width = fa.shape

    def kernel():
        return framepath.blur_blend_rect(content, fa, k.values, k.total)

    def plain():
        return framepath.apply_blur_rect(unpack_rgba(content[:height, :width]), fa, k.values, k.total)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    require(torch.equal(got, want), "blur_blend's rect mode differs from apply_blur_rect")
    row = {"max_abs_err": max_abs_err(got, want),
           **blur_bound(torch, fa, content.shape[1], 0, 0, 0, 0, height, width, None, height, width, k.radius,
                        rect=True),
           "ms": event_ms(torch, kernel, scrub, wait_ms=ANIMATED_WAIT_MS, queued=True),
           "plain_ms": event_ms(torch, plain, scrub)}
    row["share"] = row["bound_ms"] / row["ms"]
    return row


def lion_kernels(torch, dev, scrub):
    """Phase 3: composite_full and composite_dirty against their plain
    versions on the lion's lists, and against composite_full_banded and
    composite_dirty_banded over one band, then the deep case, then
    blur_blend (both modes) and shatter_into on the lion's first animated
    step.  Returns {kernel: row}."""
    from coherence_tpu_torch.raster import staging
    from coherence_tpu_torch.raster import tiled_scene as T

    view, disp, key = build_scene(dev)
    ts = view.ts
    atlas = ts.atlas()
    starts, idxs = ts.build_lists(view.order)
    full_k = T.composite_full(starts, idxs, view.background, atlas, ts.nty, ts.ntx)
    full_p = T.composite_full_torch(starts, idxs, view.background, atlas, ts.nty, ts.ntx)

    def full_banded():
        return T.composite_full_banded(one_band(starts), one_band(idxs), view.background, one_band(atlas), ts.nty,
                                       ts.ntx)

    full_b = full_banded()
    torch.cuda.synchronize()
    require(torch.equal(full_k, full_p), "composite_full differs from composite_full_torch")
    require(torch.equal(full_k, full_b), "composite_full differs from composite_full_banded over one band")
    full = {"max_abs_err": max_abs_err(full_k, full_p),
            **bound([walked_depths(torch, atlas, idxs, full_spans(torch, starts))])}
    full.update(in_turns(torch, lambda: T.composite_full(starts, idxs, view.background, atlas, ts.nty, ts.ntx),
                         scrub, banded_one_band=full_banded))
    full["plain_ms"] = event_ms(
        torch, lambda: T.composite_full_torch(starts, idxs, view.background, atlas, ts.nty, ts.ntx), scrub)
    n_listed = int(starts[-1])

    moved, (oys, oxs, base), entries, win, dirty = disp.stage_animated(key, *delta(0))
    require(dirty is not None, "the first animated step has no blur window")
    coords, spans, didx, n_slots = dirty
    n_real = len({(int(coords[2 * j]), int(coords[2 * j + 1])) for j in range(n_slots)})
    dirty_tiles = {int(coords[2 * j]) * ts.ntx + int(coords[2 * j + 1]) for j in range(n_real)}
    spare = next(t for t in range(ts.nty * ts.ntx) if t not in dirty_tiles)
    coords, spans, n_slots = with_passthrough(coords, spans, n_real, (spare // ts.ntx, spare % ts.ntx))
    datlas = T.shatter_into(atlas.clone(), moved.rgba, oys, oxs, base)
    args = staging.stage(dev, coords, spans, didx)
    noise = torch.randint(-(2**31), 2**31 - 1, view.frame.shape, dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    frame_k, frame_p, frame_b = noise.clone(), noise.clone(), noise.clone()
    T.composite_dirty(*args, view.background, frame_k, datlas, n_slots)
    T.composite_dirty_torch(*args, view.background, frame_p, datlas, n_slots)

    def dirty_banded():
        T.composite_dirty_banded(*(one_band(a) for a in args), view.background, frame_b, one_band(datlas), n_slots)

    dirty_banded()
    torch.cuda.synchronize()
    require(torch.equal(frame_k, frame_p), "composite_dirty differs from composite_dirty_torch")
    require(torch.equal(frame_k, frame_b), "composite_dirty differs from composite_dirty_banded over one band")
    sy, sx = (spare // ts.ntx) * 64, (spare % ts.ntx) * 128
    require(torch.equal(frame_k[sy : sy + 64, sx : sx + 128], noise[sy : sy + 64, sx : sx + 128]),
            "composite_dirty wrote a passthrough tile")
    dspans = dirty_spans(torch, coords, spans, n_slots, dev)
    dirty_row = {"max_abs_err": max_abs_err(frame_k, frame_p),
                 **bound([walked_depths(torch, datlas, args[2], dspans)])}
    dirty_row.update(in_turns(torch, lambda: T.composite_dirty(*args, view.background, frame_k, datlas, n_slots),
                              scrub, banded_one_band=dirty_banded))
    dirty_row["plain_ms"] = event_ms(
        torch, lambda: T.composite_dirty_torch(*args, view.background, frame_p, datlas, n_slots), scrub)
    deep = deep_case(torch, dev, scrub)
    animated = animated_kernels(torch, dev, view, disp, key, delta(0), scrub)
    animated["blur_blend"]["rect"] = blur_rect_row(torch, dev, view, disp, scrub)
    emit({"phase": "kernels", "tolerance": 0,
          "composite_full": {"equal_plain": True, "equal_banded_one_band": True, "tiles": ts.nty * ts.ntx,
                             "listed_pieces": n_listed, **full},
          "composite_dirty": {"equal_plain": True, "equal_banded_one_band": True, "slots": n_slots,
                              "real_slots": n_real + 1, "passthrough_tile": spare,
                              "listed_pieces": int(spans[2 * n_real + 1]), **dirty_row},
          "banded_one_band": "composite_full_banded and composite_dirty_banded over one band (the same striped ring)",
          "deep": deep, "blur_blend": {"equal_plain": True, **animated["blur_blend"]},
          "shatter_into": {"equal_plain": True, **animated["shatter_into"]},
          "launch_floor_ms": animated["launch_floor_ms"]})
    return {"composite_full": full, "composite_dirty": dirty_row, **animated}


def lion_path(torch, dev, kernels):
    """Phase 4: the lion's main path, counted from zero.  Returns the
    launch counts."""
    from coherence_tpu_torch.raster import tile_raster
    from coherence_tpu_torch.scene import fastframe

    # The first frames on the CPU, through the plain versions, built cold:
    # neither build restores another's atlas or sweep (H37).
    cold_caches()
    t0 = time.perf_counter()
    cview, cdisp, ckey = build_scene("cpu")
    cpu_build_s = time.perf_counter() - t0
    cpu_atlas = cview.ts.atlas().clone()
    cpu_alpha = cdisp.f_alpha.clone()
    cpu_display0 = cdisp.rgba.clone()
    for k in range(N_CHECK):
        cdisp.step_animated(ckey, *delta(k))
    cpu_display = cdisp.rgba.clone()
    del cview, cdisp

    cold_caches()
    zero_counts(torch, kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    view, disp, key = build_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_caches = {"scene_build": fastframe.scene_build_cache_stats(), "sweep": dict(tile_raster.sweep_cache_stats)}
    build_tile_raster = kernels.launches["tile_raster"]
    require(build_caches["scene_build"]["misses"] == 1 and build_tile_raster >= 1,
            f"the lion's build on the card did not rasterize its own atlas: {build_caches}, "
            f"{build_tile_raster} tile_raster launches")
    require(torch.equal(view.ts.atlas().cpu(), cpu_atlas), "card atlas differs from the CPU build")
    require(torch.equal(disp.f_alpha.cpu(), cpu_alpha), "card alpha plane differs from the CPU build")
    require(torch.equal(disp.rgba.cpu(), cpu_display0), "card full refresh differs from the CPU one")
    snapshot = []

    def frame(k):
        disp.step_animated(key, *delta(k))
        if k == N_CHECK - 1:
            snapshot.append(disp.rgba.clone())

    frame_ms, loop_s = timed_frames(torch, frame, N_FRAMES)
    require(torch.equal(snapshot[0].cpu(), cpu_display),
            f"display after {N_CHECK} frames differs from the CPU plain path")
    dirty_content = view.frame.clone()
    view.render(full=True)
    torch.cuda.synchronize()
    require(torch.equal(view.frame, dirty_content), "render(full=True) differs from the dirty-path content")
    require(tuple(disp.rgba.shape) == (H, W, 4) and disp.rgba.dtype == torch.int32, "display shape or type")
    require(bool(((disp.rgba >= 0) & (disp.rgba <= 255)).all()), "display channels outside 0..255")
    counts = dict(kernels.launches)
    require(counts["composite_dirty"] >= N_FRAMES + 1, f"composite_dirty launched {counts['composite_dirty']} times")
    require(counts["composite_full"] >= 1, "composite_full never launched on the main path")
    # Each frame: one shatter, one window blend; the full refresh: the rect blend.
    require(counts["shatter_into"] >= N_FRAMES, f"shatter_into launched {counts['shatter_into']} times")
    require(counts["blur_blend"] >= N_FRAMES + 1, f"blur_blend launched {counts['blur_blend']} times")
    # A steady frame is the JAX package's one program: one copy and three launches.
    from profile_general import issued

    steady_ops = [issued(torch, lambda k=k: disp.step_animated(key, *delta(k))) for k in range(N_FRAMES, N_FRAMES + 3)]
    require(steady_ops == [STEADY_FRAME_OPS] * 3,
            f"steady frames issued {steady_ops} launches and copies, not {STEADY_FRAME_OPS} each")
    stats = frame_stats(frame_ms)
    emit({"phase": "main_path", "frames": N_FRAMES, "build_s": build_s, "cpu_reference_build_s": cpu_build_s,
          "build_tile_raster": build_tile_raster, "build_caches": build_caches,
          "first_frame_ms": stats["first_ms"], "frame_ms_median": stats["median_ms"],
          "frame_ms_p95": stats["p95_ms"], "host_ms_per_frame": loop_s / N_FRAMES * 1e3,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
          "ops_per_steady_frame": steady_ops, "display_equal_cpu_after_frames": N_CHECK,
          "full_render_equal_dirty": True})
    return {**counts, "tile_raster_build": build_tile_raster}


def scene_caches_clear() -> None:
    """Empty the scene-build cache and the sweep cache: the next tiled build
    rasterizes its own atlas and sweeps its own objects (H37; the digest
    and the sweep's key name no device)."""
    from coherence_tpu_torch.raster import tile_raster
    from coherence_tpu_torch.scene import fastframe

    fastframe.scene_build_cache_clear()
    tile_raster.sweep_cache_clear()


def cold_caches() -> None:
    """Empty the coherence cache and scene_caches_clear's caches, and zero
    the scene-build cache's counts, so that the next build starts cold
    (H23, H37)."""
    from coherence_tpu_torch.scene import cache, fastframe

    cache.clear()
    scene_caches_clear()
    fastframe.scene_build_cache_stats(reset=True)


def interactive_path(torch, dev, kernels, scrub):
    """Phases 5 and 6: config 5 on the card, counted from zero, then
    composite_runs against its plain version and composite_full, and
    composite_full against composite_full_banded over one band, on the 1x
    scene's full-frame lists, the three timed in turns; blur_blend and
    shatter_into on the inputs of one of its animated steps.  Returns
    (launch counts, composite_runs's row, composite_full's row on these
    lists, blur_blend's and shatter_into's rows)."""
    from coherence_tpu_torch.raster import tiled_scene as T
    from coherence_tpu_torch.scene import fastframe

    from coherence_tpu_torch.raster import tile_raster

    # The first 3 filtered frames on the CPU, through the plain versions.
    cold_caches()
    t0 = time.perf_counter()
    cview, cdisp, ckey, _ = build_interactive("cpu")
    for k in range(3):
        filtered_frame(cview, cdisp, ckey, k)
    cpu_s = time.perf_counter() - t0
    cpu_atlas, cpu_pieces = scene_state(cview)
    cpu_display = cdisp.rgba.clone()
    del cview, cdisp

    zero_counts(torch, kernels)
    torch.cuda.reset_peak_memory_stats()
    cold_caches()
    t0 = time.perf_counter()
    view, disp, key, objs = build_interactive(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_tile_raster = kernels.launches["tile_raster"]
    build_sweep = dict(tile_raster.sweep_cache_stats)
    require(build_tile_raster >= 1 and build_sweep["hits"] == 0,
            f"config 5's build on the card: {build_tile_raster} tile_raster launches, sweep cache {build_sweep}")
    for k in range(3):
        filtered_frame(view, disp, key, k)
    atlas, pieces = scene_state(view)
    require(pieces == cpu_pieces, "4K piece lists differ from the CPU run")
    require(torch.equal(atlas, cpu_atlas), "4K atlas differs from the CPU run")
    require(torch.equal(disp.rgba.cpu(), cpu_display), "4K display after 3 filtered frames differs from the CPU run")
    counts_checked = dict(kernels.launches)
    require(counts_checked["shatter_into"] >= 3 and counts_checked["blur_blend"] >= 4,
            f"config 5's filtered frames did not reach shatter_into and blur_blend: {counts_checked}")
    # The build's brush groups, each one brush_stamp launch in piece mode.
    require(counts_checked["brush_stamp"] >= 1, f"config 5's build did not launch brush_stamp: {counts_checked}")
    filtered_ms, filtered_s = timed_frames(torch, lambda k: filtered_frame(view, disp, key, k), N_FRAMES4)
    plain_ms, plain_s = timed_frames(torch, lambda k: plain_frame(view, key, k), N_FRAMES4)
    dirty_content = view.frame.clone()
    view.render(full=True)
    starts, idxs = view.ts.build_lists(view.order)
    runs_frame = view.ts.render_runs(view.background, starts, idxs)
    animated = uncounted(kernels, lambda: animated_kernels(torch, dev, view, disp, key, delta4(0), scrub))
    torch.cuda.synchronize()
    require(torch.equal(view.frame, dirty_content), "4K render(full=True) differs from the dirty-path content")
    require(torch.equal(runs_frame, view.frame), "4K render_runs differs from render(full=True)")
    # The 1x scene's lists and atlas, for the kernel checks after the zooms.
    atlas_1x, background = view.ts.atlas().clone(), view.background
    nty, ntx = view.ts.nty, view.ts.ntx
    zooms, cur = [], objs
    for rep in range(N_ZOOMS):
        f = 2.0 if rep % 2 == 0 else 0.5
        cur = zoomed(cur, f)
        misses, stamps = fastframe.scene_build_cache_stats()["misses"], kernels.launches["brush_stamp"]
        tiles, sweep = kernels.launches["tile_raster"], dict(tile_raster.sweep_cache_stats)
        t0 = time.perf_counter()
        view.reset_scene(cur, tiled=True)
        view.render(full=True)
        torch.cuda.synchronize()
        zooms.append({"factor": f, "seconds": time.perf_counter() - t0, "pieces": view.ts._n_pieces,
                      **fastframe.scene_build_cache_stats(), "brush_stamp": kernels.launches["brush_stamp"] - stamps,
                      "tile_raster": kernels.launches["tile_raster"] - tiles,
                      "sweep": {k: tile_raster.sweep_cache_stats[k] - sweep[k] for k in sweep}})
        # A miss rebuilds the strokes and the paths: at least one brush_stamp and one tile_raster launch; a hit
        # restores the atlas.
        missed = zooms[-1]["misses"] > misses
        for name in ("brush_stamp", "tile_raster"):
            require(zooms[-1][name] >= 1 if missed else zooms[-1][name] == 0,
                    f"zoom step {rep}: {zooms[-1][name]} {name} launches on a {'miss' if missed else 'hit'}")
    fastframe.scene_build_cache_stats(reset=True)
    tiles = kernels.launches["tile_raster"]
    t0 = time.perf_counter()
    view.prefetch_zoom_candidates(cur)
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t0
    prefetch_tile_raster = kernels.launches["tile_raster"] - tiles
    require(prefetch_tile_raster >= 1, "the prefetch built no scene through tile_raster")
    half = zoomed(cur, 0.5)
    t0 = time.perf_counter()
    view.reset_scene(half, tiled=True)
    view.render(full=True)
    torch.cuda.synchronize()
    half_s = time.perf_counter() - t0
    half_stats = fastframe.scene_build_cache_stats()
    require(half_stats["hits"] == 1, f"the prefetched 0.5x step missed the scene-build cache: {half_stats}")
    require(bool((((view.frame >> 24) & 0xFF) == 255).all()), "4K frame over white is not opaque")
    counts = dict(kernels.launches)
    require(counts["composite_dirty"] >= 2 * N_FRAMES4, f"4K composite_dirty launched {counts['composite_dirty']}")
    require(counts["composite_full"] >= N_ZOOMS + 2, f"4K composite_full launched {counts['composite_full']}")
    require(counts["composite_runs"] >= 1, "composite_runs never launched on the 4K path")
    emit({"phase": "interactive_4k", "width": W4, "height": H4, "objects": len(objs) + 1,
          "pieces": sum(len(p) for p in pieces), "listed_pieces": int(starts[-1]), "build_s": build_s,
          "build_tile_raster": build_tile_raster, "build_sweep": build_sweep,
          "prefetch_tile_raster": prefetch_tile_raster,
          "cpu_reference_s": cpu_s, "cpu_reference_size": [W4, H4], "filtered": frame_stats(filtered_ms),
          "filtered_host_ms_per_frame": filtered_s / N_FRAMES4 * 1e3, "plain": frame_stats(plain_ms),
          "plain_host_ms_per_frame": plain_s / N_FRAMES4 * 1e3, "zooms": zooms, "prefetch_s": prefetch_s,
          "prefetched_step_s": half_s, "prefetched_step_cache": half_stats,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
          "equal_cpu_after_frames": 3, "full_render_equal_dirty": True, "render_runs_equal_full": True})
    del view, disp, objs, cur, half, dirty_content, runs_frame
    scene_caches_clear()

    runs = T.gather_runs(atlas_1x, idxs)
    runs_k = T.composite_runs(starts, background, runs, nty, ntx)
    runs_p = T.composite_runs_torch(starts, background, runs, nty, ntx)
    full = T.composite_full(starts, idxs, background, atlas_1x, nty, ntx)

    def full_banded():
        return T.composite_full_banded(one_band(starts), one_band(idxs), background, one_band(atlas_1x), nty, ntx)

    full_b = full_banded()
    torch.cuda.synchronize()
    require(torch.equal(runs_k, runs_p), "composite_runs differs from composite_runs_torch")
    require(torch.equal(runs_k, full), "composite_runs differs from composite_full on the same lists")
    require(torch.equal(full, full_b), "4K composite_full differs from composite_full_banded over one band")
    walk = bound([walked_depths(torch, atlas_1x, idxs, full_spans(torch, starts))])
    turns = in_turns(torch, lambda: T.composite_full(starts, idxs, background, atlas_1x, nty, ntx), scrub,
                     banded_one_band=full_banded,
                     composite_runs=lambda: T.composite_runs(starts, background, runs, nty, ntx))
    runs_row = {"max_abs_err": max_abs_err(runs_k, runs_p), **walk, "ms": turns["composite_runs_ms"],
                "composite_full_ms": turns["ms"],
                "plain_ms": event_ms(torch, lambda: T.composite_runs_torch(starts, background, runs, nty, ntx), scrub)}
    full_row = {**walk, "ms": turns["ms"], "banded_one_band_ms": turns["banded_one_band_ms"]}
    emit({"phase": "kernels_4k", "tolerance": 0, "tiles": nty * ntx, "listed_pieces": int(starts[-1]),
          "order": "composite_full_banded over one band, composite_runs, composite_full twice, then back",
          "readings": turns["readings"],
          "composite_runs": {"equal_plain": True, "equal_composite_full": True, "runs_pieces": int(runs.shape[0]),
                             "gather_runs_ms": event_ms(torch, lambda: T.gather_runs(atlas_1x, idxs), scrub),
                             **runs_row},
          "composite_full": {"equal_banded_one_band": True, **full_row},
          "blur_blend": {"equal_plain": True, **animated["blur_blend"]},
          "shatter_into": {"equal_plain": True, **animated["shatter_into"]},
          "launch_floor_ms": animated["launch_floor_ms"]})
    counts.update({"tile_raster_build": build_tile_raster, "tile_raster_prefetch": prefetch_tile_raster,
                   "tile_raster_zooms": [z["tile_raster"] for z in zooms]})
    return counts, runs_row, full_row, animated


def brush_inputs(torch, dev) -> dict:
    """The brush kernels' inputs as the program's paths give them on `dev`,
    name -> (mode, arguments): plane mode at profile_general.py's brush
    program (mkround(15.0, 0.5) along a circle of radius 250: a 31x31
    patch, 1013 stamps) and at the same circle under mkround(120.0, 0.5);
    the smear at profile_general.py's smear program (1024 steps of the
    31x31 brush over its 711x611 sprite, two passes); piece mode at each
    of config 5's brush groups as its scene build stages them
    (stage_tiled_scene), at 3840x2160 and after one 2x zoom."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import brush, fills, region
    from coherence_tpu_torch.scene import examples, fastframe
    from profile_general import programs, recorded_brush_calls

    progs = programs(torch, dev)
    wide = (brush.mkround(120.0, 0.5), gshapes.circle(300.0, 300.0, 250.0))
    # A radius-120 smear (smear_walk's global mode) along a 400-pixel stroke over a 900x700 gradient.
    line = gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, False, (gpath.Straight((250.0, 350.0), (650.0, 380.0)),)),))
    grad = fills.gradient((0.0, 0.0), (900.0, 700.0), True, True, C.red, C.dissolve(C.blue, delta=120))
    canvas = region.fillshape(region.shape_of_box((1, 1, 900, 700), dev), grad)
    with recorded_brush_calls() as calls:
        progs["sprite_of_brushstroke"][2]()
        brush.sprite_of_brushstroke(wide, fills.plain(C.darkorange), brush.shape_of_brushstroke(wide, dev)[0], dev)
        progs["smear"][2]()
        brush.smear(canvas, (brush.mkround(120.0, 1.0), line), dev)
    stamps = [args for name, args in calls if name == "_stamp_alpha"]
    smears = [args for name, args in calls if name == "_smear_walk"]
    require(len(stamps) == 2 and len(smears) == 2, f"the brush programs made {len(stamps)} stamp walks and "
            f"{len(smears)} smears, not 2 and 2")
    out = {"plane_31x31": ("plane", stamps[0]), "plane_r120": ("plane", stamps[1]), "smear": ("smear", smears[0]),
           "smear_r120": ("smear", smears[1])}
    objs = examples.interactive_4k_scene(W4, H4)[0]
    for name, scene in (("config5", objs), ("config5_zoom2x", zoomed(objs, 2.0))):
        ph, pw = -(-H4 // 64) * 64, -(-W4 // 128) * 128
        build = fastframe.stage_tiled_scene(ph // 64, pw // 128, pw, ph, list(enumerate(scene)), dev)[1]
        for k, gkey in enumerate(sorted(build.groups)):
            out[f"{name}_group{k}"] = ("pieces", (build, gkey))
    return out


def stamp_bound(torch, lists, brushes, offsets, valid, hp: int, wp: int, out_words: int, windows=None,
                extra=()) -> dict:
    """What brush_stamp must do: write its output once (4 bytes a word) and
    read its host records once (as the first design read them, so that a
    share compares across designs: a (row, col) int32 record a stamp of
    `offsets`, valid or not, the stroke table and patches of `lists`, and
    the arrays of `extra`; brush_row prints the bytes of the launch's own
    lists beside it); and STAMP_OPS int32 operations for each nonzero texel
    of each valid stamp that lands on an output pixel: the whole plane in
    plane mode, in piece mode the piece windows (stroke, row, col) of
    `windows`."""
    import numpy as np

    records = 8 * offsets.shape[0] * offsets.shape[1] + lists.strokes.nbytes + lists.patches.nbytes
    n_bytes = 4 * out_words + records + sum(a.nbytes for a in extra)
    nz = [(b != 0).astype(np.int64) for b in brushes]
    if windows is None:
        updates = sum(int(valid[si].sum()) * int(nz[si].sum()) for si in range(len(brushes)))
    else:
        updates, bhb, bwb = 0, brushes.shape[1], brushes.shape[2]
        for si in sorted({int(w[0]) for w in windows}):
            plane = np.zeros((hp, wp), np.int64)  # the stamp texels over each pixel
            for oy, ox in offsets[si][valid[si]]:
                plane[oy : oy + bhb, ox : ox + bwb] += nz[si]
            updates += sum(int(plane[oy : oy + 64, ox : ox + 128].sum()) for s_, oy, ox in windows if s_ == si)
    ops = STAMP_OPS * updates
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "stamp_pixel_updates": updates, "operations": ops, "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}


def smear_bound(opac, offsets, dirs, height: int, width: int) -> dict:
    """What smear_walk must do over its SMEAR_PASSES passes on an (height,
    width) canvas: read once each canvas pixel that a step reads before the
    walk has written it, and write once each pixel that a step writes (16
    bytes a pixel); and SMEAR_OPS int32 operations for each channel of each
    step's mixed pixels.  A texel of al == 255 reads and writes nothing, one
    of al == 0 reads only its source.  Beside it, step_bytes: the walk's
    traffic step by step (each step reads the union of its source and
    destination patches, (bh + |dy|) x (bw + |dx|) pixels, and writes its
    patch), which stays in L2: the walk is a serial chain of serial_steps
    dependent steps, and chain_floor_ms: those steps' operations at one
    SM's share of the int32 rate (SMS), the least time a walk on one block
    can take."""
    import numpy as np

    from coherence_tpu_torch import kernels

    opac = np.asarray(opac)
    bh, bw = opac.shape
    moves, mixes = opac != 255, (opac != 0) & (opac != 255)
    read, written = np.zeros((height, width), bool), np.zeros((height, width), bool)
    step_pixels = 0
    for _ in range(kernels.SMEAR_PASSES):
        for (r, c), (dx, dy) in zip(offsets, dirs):
            src = (slice(r - dy, r - dy + bh), slice(c - dx, c - dx + bw))
            dst = (slice(r, r + bh), slice(c, c + bw))
            read[src] |= moves & ~written[src]
            read[dst] |= mixes & ~written[dst]
            written[dst] |= moves
            step_pixels += (bh + abs(dy)) * (bw + abs(dx)) + bh * bw
    steps = kernels.SMEAR_PASSES * len(offsets)
    n_bytes = 16 * (int(read.sum()) + int(written.sum()))
    ops = SMEAR_OPS * 4 * int(mixes.sum()) * steps
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": ops, "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations", "step_bytes": 16 * step_pixels,
            "serial_steps": steps, "chain_floor_ms": ops / (INT_OPS_PER_S / SMS) * 1e3}


def smear_mode(stats, total: int) -> dict:
    """smear_walk's mode from the `stats` its launch wrote ((4,) int32:
    window rows and columns, the window's loads, the step from which the
    walk ran in device memory) for a walk of `total` steps: the mode, the
    window, its loads (reloads, the first included) and that step
    (device_from: None where the window walk reached the end)."""
    wh, ww, loads, device_from = (int(x) for x in stats.tolist())
    if not wh:
        return {"mode": "global", "window": None, "reloads": None, "device_from": 0}
    return {"mode": "window", "window": [wh, ww], "reloads": loads,
            "device_from": None if device_from == total else device_from}


def brush_row(torch, dev, scrub, mode: str, args) -> dict:
    """One brush kernel against its plain version on the card, bit for bit,
    with its bound; then the wrapper's host time (fold_host_ms) and the two
    timed: the kernel behind a device-side wait of max(ANIMATED_WAIT_MS, 4
    x the slowest host call), each call queued within half of it (H42),
    its lists' staged copy in the window (ms); the plain version over
    N_BRUSH_PLAIN_TIMED calls (it runs one step of torch operations a
    stamp, its host time in its window).  brush_stamp's row also gives the
    kernel alone on lists staged beforehand (kernel_ms; that launch's output
    is first held to the plain version, bit for bit) and the staged copy
    alone (copy_ms), both behind a wait of ANIMATED_WAIT_MS; the blocks of
    the launch, the longest and mean list a block reads
    (kernels.brush_list_stats), the patch's shared memory, the blocks an SM
    holds, and the bytes of the lists as the kernel reads them
    (layout_bytes; the bound counts the first design's records).  A
    smear's row also gives smear_walk's mode, window and reloads, as the
    kernel counted them in its checked call (smear_mode)."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import brush

    if mode == "plane":
        brushes, offsets, valid, hp, wp, _ = args
        shape = {"strokes": len(brushes), "plane": [hp, wp], "patch": list(brushes.shape[1:]),
                 "stamps": int(valid.sum())}

        def kernel():
            return brush._stamp_alpha(brushes, offsets, valid, hp, wp, dev)

        def plain():
            return brush._stamp_alpha_torch(brushes, offsets, valid, hp, wp, dev)

        got, want = kernel(), plain()
        lists = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
        bound = stamp_bound(torch, lists, brushes, offsets, valid, hp, wp, got.numel())
    elif mode == "pieces":
        from coherence_tpu_torch.raster.brush_tiles import _group_lists

        build, gkey = args
        items = build.groups[gkey]
        brushes, offsets, valid, points, fills, radii, meta = _group_lists(gkey[4], items)
        hp, wp = gkey[:2]
        shape = {"strokes": len(items), "plane": [hp, wp], "patch": list(gkey[2:4]), "stamps": int(valid.sum()),
                 "pieces": sum(len(it[7]) for it in items), "block_pieces": len(meta)}

        def kernel():
            return build._group_block(*gkey, items)

        def plain():
            return build._group_block_torch(*gkey, items)

        got, want = kernel(), plain()
        lists = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp, wp)
        bound = stamp_bound(torch, lists, brushes, offsets, valid, hp, wp, got.numel(), [tuple(m) for m in meta],
                            (points, meta))
    else:
        cv, opac, offsets, dirs, bh, bw = args
        work = cv.clone()
        shape = {"canvas": list(cv.shape[:2]), "patch": [bh, bw], "steps": len(offsets)}

        def kernel():
            return brush._smear_walk(work, opac, offsets, dirs, bh, bw)

        def plain():
            return brush._smear_walk_torch(work, opac, offsets, dirs, bh, bw)

        stats = torch.zeros(4, dtype=torch.int32, device=dev)
        got = kernels.smear_walk(cv.clone(), opac, offsets, dirs, bh, bw, stats=stats)
        want = brush._smear_walk_torch(cv.clone(), opac, offsets, dirs, bh, bw)
        bound = {**smear_bound(opac.cpu().numpy(), offsets, dirs, *cv.shape[:2]),
                 **smear_mode(stats, kernels.SMEAR_PASSES * len(offsets))}
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"brush kernel ({mode} mode) differs from its plain version at {shape}")
    require(bool((want != 0).any()), f"brush kernel ({mode} mode): the case at {shape} is all zero")
    row = {**shape, "max_abs_err": max_abs_err(got, want), **bound, **fold_host_ms(torch, kernel)}
    row["wait_ms"] = max(ANIMATED_WAIT_MS, 4 * row["host_ms_max"])
    retaken = RETAKEN[0]
    row["ms"] = event_ms(torch, kernel, scrub, wait_ms=row["wait_ms"], queued=True)
    row["retaken"] = RETAKEN[0] - retaken
    row["plain_ms"] = event_ms(torch, plain, scrub, reps=N_BRUSH_PLAIN_TIMED)
    row["share"] = row["bound_ms"] / row["ms"]
    if mode != "smear":
        staged = kernels.stage_brush_lists(lists, dev)
        alone = kernels.brush_stamp(lists, staged)
        torch.cuda.synchronize()
        require(torch.equal(alone, want), f"brush_stamp ({mode} mode) on lists staged beforehand differs from its "
                f"plain version at {shape}")
        row["kernel_ms"] = event_ms(torch, lambda: kernels.brush_stamp(lists, staged), scrub, wait_ms=ANIMATED_WAIT_MS,
                                    queued=True)
        row["copy_ms"] = event_ms(torch, lambda: kernels.stage_brush_lists(lists, dev), scrub,
                                  wait_ms=ANIMATED_WAIT_MS, queued=True)
        row["kernel_share"] = row["bound_ms"] / row["kernel_ms"]
        row.update(kernels.brush_list_stats(lists), patch_smem=lists.patch_smem,
                   layout_bytes=sum(a.nbytes for a in staged_arrays(lists)),
                   blocks_per_sm=kernels.brush_stamp_blocks_per_sm(lists.piece, lists.patch_smem))
    return row


def staged_arrays(lists) -> tuple:
    """The arrays of a brush_stamp launch's staged copy, as
    kernels.stage_brush_lists stages them."""
    return lists.ranges, lists.stamps, lists.points, lists.strokes, lists.patches, lists.meta


def brush_kernels(torch, dev, kernels, scrub, floor_ms: float) -> dict:
    """brush_stamp (both modes) and smear_walk against their plain versions
    on the card at brush_inputs' shapes, each a brush_row.  Returns the
    kernels line's rows: {"brush_stamp": config 5's largest group with
    every shape beside it, "smear_walk": the smear (window mode), the
    radius-120 smear (global mode) beside it}."""
    rows = uncounted(kernels, lambda: {name: brush_row(torch, dev, scrub, mode, args)
                                       for name, (mode, args) in brush_inputs(torch, dev).items()})
    for row in rows.values():
        row["launch_floor_ms"] = floor_ms
    emit({"phase": "brush_kernels", "tolerance": 0, "equal_plain": True, "shapes": rows})
    groups = [name for name in rows if name.startswith("config5_group")]
    main = max(groups, key=lambda name: rows[name]["pieces"])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes", "share", "host_ms")
    stamp_keys = (*keys, "kernel_ms", "copy_ms", "kernel_share", "blocks", "stamp_list_max", "stamp_list_mean")
    smears = ("smear", "smear_r120")
    stamp = {**rows[main], "shape": main, "max_abs_err": max(rows[n]["max_abs_err"] for n in rows if n not in smears),
             "shapes": {name: {k: row[k] for k in stamp_keys} for name, row in rows.items() if name not in smears}}
    wide = rows["smear_r120"]
    require(rows["smear"]["mode"] == "window" and rows["smear"]["device_from"] is None,
            f"the smear demo did not walk its window to the end: {rows['smear']['mode']}, {rows['smear']['device_from']}")
    require(wide["mode"] == "global", f"the radius-120 smear took {wide['mode']} mode")
    smear = {**rows["smear"], "max_abs_err": max(rows[n]["max_abs_err"] for n in smears),
             "global_r120": {k: wide[k] for k in (*keys, "mode", "patch", "steps", "chain_floor_ms", "serial_steps")}}
    return {"brush_stamp": stamp, "smear_walk": smear}


def tile_inputs(torch, dev) -> dict:
    """TR1's inputs as the build stages them on `dev`, name -> TileBuild:
    the lion's 132 paths over its 17 x 15 tile grid (build_scene's
    set_scene), and config 5's 1000 shapes over its 34 x 30 grid
    (build_interactive's)."""
    from coherence_tpu_torch.scene import examples, fastframe

    objs, _, _ = examples.bench_scene(W, H, blob_radius=60, blob_at=(120, 400), f_box=F_BOX)
    objs4, _, _ = examples.interactive_4k_scene(W4, H4)
    return {name: fastframe.stage_tiled_scene(-(-h // 64), -(-w // 128), w, h, [(o.idset, o) for o in scene], dev)[0]
            for name, scene, w, h in (("lion", objs, W, H), ("config5", objs4, W4, H4))}


def tile_bound(batches) -> dict:
    """What TR1 must do for a build's blocks: its lists read once, counted
    as 4 bytes a span on a row of its plane, a row offset (rows + 1 of each
    family of each item) and a fill channel, and every slot of every block
    written once (PIECE_BYTES), over HBM_BYTES_PER_S; and its operations,
    1024 multiply-adds (two int32 operations each) at each fringe pixel
    (the coverage mask's pixels of the edge items), at INT_OPS_PER_S.  The
    bound is the larger.  The count is the work's, not the bytes of the
    kernel's list layout (tile_raster_row prints those beside it), so that
    a share before and after a change of layout measures the same work."""
    from coherence_tpu_torch.raster import tile_raster

    spans = offsets = 0
    for items, _, edge in batches:
        for k, h in ((2, 64), (3, 64), (4, 1040)) if edge else ((2, 64),):
            spans += sum(int(((it[k][0] >= 0) & (it[k][0] < h)).sum()) for it in items)
            offsets += len(items) * (h + 1)
    list_bytes = 4 * (spans + offsets + 4 * sum(len(items) for items, _, _ in batches))
    n_bytes = list_bytes + sum(nb for _, nb, _ in batches) * PIECE_BYTES
    fringe = sum(int(tile_raster._tile_masks([it[2] for it in items], 64, 128, "cpu").sum())
                 for items, _, edge in batches if edge)
    ops = 2 * 1024 * fringe
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"list_bytes": list_bytes, "bytes": n_bytes, "fringe_pixels": fringe, "operations": ops,
            "bound_ms": max(byte_ms, ops_ms), "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}


def tile_raster_row(torch, dev, scrub, tb) -> dict:
    """TR1 over one build's flush (every batch of tb.batches() in one
    launch) against the plain version on the card, bit for bit, with its
    bound (tile_bound) and, beside it, the bytes of the lists as the kernel
    reads them (layout_bytes: rows, packed columns, offsets, fills and the
    unit table).  Timed with the lists staged beforehand (the window holds
    the launch alone), behind a device-side wait of ANIMATED_WAIT_MS, each
    call queued within half of it; the wrapper's whole host side (packing,
    staged copy, launch) as host_ms (fold_host_ms over TileBuild.flush);
    the plain version over N_BRUSH_PLAIN_TIMED calls; each block alone, a
    launch over one class's block (blocks_ms); one TileBuild.flush's issued
    launches and copies (profile_general.issued), required to be two; the
    blocks of the launch that an SM holds (the occupancy calculator)."""
    from coherence_tpu_torch import kernels
    from profile_general import issued

    batches = list(tb.batches())
    blocks = [tb.kernel_lists(*b) for b in batches]
    lists = kernels.stage_tile_lists(blocks, dev)
    alone = [kernels.stage_tile_lists([blk], dev) for blk in blocks]

    def kernel():
        return kernels.tile_raster(lists)

    def plain():
        return [tb.block_torch(*b) for b in batches]

    def wrapper():
        return tb.flush()[0]

    got, want, whole = kernel(), plain(), wrapper()
    torch.cuda.synchronize()
    got = list(got.split([nb for _, nb, _ in batches]))
    for j, (g, w, h) in enumerate(zip(got, want, whole)):
        require(torch.equal(g, w) and torch.equal(h, w), f"tile_raster's block {j} differs from its plain version")
    n_issued = issued(torch, tb.flush)
    require(n_issued == 2,
            f"one TileBuild.flush issued {n_issued} launches and copies for {len(batches)} blocks, not 2")
    row = {"blocks": len(batches), "items": sum(len(items) for items, _, _ in batches),
           "edge_items": sum(len(items) for items, _, edge in batches if edge),
           "slots": sum(nb for _, nb, _ in batches), "units": int(lists[4].shape[0]), "flush_issued": n_issued,
           "blocks_per_sm": kernels.tile_raster_blocks_per_sm(),
           "layout_bytes": sum(4 * t.numel() for t in lists[:5]),
           "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)), **tile_bound(batches),
           **fold_host_ms(torch, wrapper)}
    row["ms"] = event_ms(torch, kernel, scrub, wait_ms=ANIMATED_WAIT_MS, queued=True)
    # Each class's block alone: where a build's time goes, and what one launch for all of them saves.
    row["blocks_ms"] = [{"edge": edge, "items": len(items), "slots": nb,
                         "ms": event_ms(torch, lambda lst=lst: kernels.tile_raster(lst), scrub,
                                        wait_ms=ANIMATED_WAIT_MS, queued=True)}
                        for lst, (items, nb, edge) in zip(alone, batches)]
    row["blocks_alone_ms"] = sum(b["ms"] for b in row["blocks_ms"])
    row["plain_ms"] = event_ms(torch, plain, scrub, reps=N_BRUSH_PLAIN_TIMED)
    row["share"] = row["bound_ms"] / row["ms"]
    return row


def tile_kernels(torch, dev, kernels, scrub, floor_ms: float) -> dict:
    """TR1 at the lion's and config 5's build flush (tile_raster_row),
    uncounted.  Returns the kernels line's row: the lion's, config 5's
    beside it."""
    rows = uncounted(kernels, lambda: {name: tile_raster_row(torch, dev, scrub, tb)
                                       for name, tb in tile_inputs(torch, dev).items()})
    for row in rows.values():
        row["launch_floor_ms"] = floor_ms
    emit({"phase": "tile_kernels", "tolerance": 0, "equal_plain": True, "builds": rows})
    lion, big = rows["lion"], rows["config5"]
    keys = ("blocks", "items", "units", "fringe_pixels", "ms", "blocks_alone_ms", "plain_ms", "bound_ms", "bound_by",
            "bytes", "layout_bytes", "share", "host_ms")
    return {**lion, "max_abs_err": max(lion["max_abs_err"], big["max_abs_err"]),
            "config5": {k: big[k] for k in keys}}


def lion_members(dev):
    """The lion group of general_lion as render.py expands it: its member
    objects (fitted_lion's transform applied)."""
    from coherence_tpu_torch import ident
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import render as R

    o = fitted_lion()
    return [R.Obj(ident.new_ids(), x.geometry, tuple(tr.append(list(o.transform), list(x.transform))), x.compop)
            for x in o.geometry.objects]


def predicted_sprite_launches(objs) -> dict:
    """The SR1 launches that one build of `objs` through the batched raster
    must make, from the routing alone: one for every batched member
    together, and one for the matte of each member that takes the scalar
    route (its coverage plane's bucket over fastframe._MAX_T_ELEMS).
    Every object must be a plain-filled path or stroked path."""
    import numpy as np

    from coherence_tpu_torch.raster import aa, region, scanline
    from coherence_tpu_torch.scene import fastframe

    batched = scalar = 0
    for o in objs:
        ext = fastframe._batch_extract(o)
        require(ext is not None, "predicted_sprite_launches: an object the batched raster does not take")
        spans = scanline._edge_spans(np.asarray(ext[0], dtype=np.int64), ext[1], scanline._HALF)
        if spans is None or spans[0].size == 0:
            continue
        rows, cov_s, cov_e, x_rows, x_s, x_e = spans
        x0, x1 = min(cov_s.min(), x_s.min(initial=cov_s.min())), max(cov_e.max(), x_e.max(initial=cov_e.max()))
        hb, wb = region.bucket_hw(int(rows.max()) - int(rows.min()) + 1, int(x1) - int(x0) + 1)
        if (aa._H * hb + aa._H) * (aa._H * wb + aa._H) > fastframe._MAX_T_ELEMS:
            scalar += 1
        else:
            batched += 1
    return {"batched_members": batched, "scalar_members": scalar, "launches": int(batched > 0) + scalar}


def sprite_inputs(torch, dev) -> dict:
    """SR1's inputs as general_lion's rebuild gives them on `dev`: the
    lion's batched members (every group, as full_sprites_of_objects orders
    them) and the (box, scaled spans) of each scalar member's matte,
    recorded from kernels.sprite_raster_opacity while fastframe's grouping
    builds the scalar members."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.scene import cache, fastframe

    fresh_cache()
    mattes, real = [], kernels.sprite_raster_opacity

    def recording(box, scaled, device):
        mattes.append((box, scaled))
        return real(box, scaled, device)

    kernels.sprite_raster_opacity = recording
    try:
        _, groups = fastframe._group_members(lion_members(dev), dev)
    finally:
        kernels.sprite_raster_opacity = real
    cache.clear()
    return {"groups": groups, "mattes": mattes}


def h61_matte():
    """A matte past the first design's span packing (H61): a rectangle's
    16x spans over a box 131,071 pixels wide and 2 tall, (box, scaled):
    empty footprints at its left end, mixed ones at both ends, full ones
    between."""
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.geometry import shapes as gs
    from coherence_tpu_torch.raster import scanline

    rect = gs.rectangle(6.3, 0.0, 131066.9, 10.0)
    scaled = scanline.scaled_spans_of_edgelist(gpath.edgelist_of_path(rect), rect.winding, 16)
    return (3, 5, 3 + 131070, 6), scaled


def mixed_pixels(torch, box, scaled, device) -> int:
    """The pixels of a matte over `box` whose 32 x 32 footprint holds set
    and clear samples both: the only ones SR1's opacity mode counts (an
    all-clear footprint is 0, an all-set one 255).  From the t-plane in
    coverage_opacity_torch's row bands, each 16 x 16 block's set samples
    summed and four blocks a footprint."""
    import numpy as np

    from coherence_tpu_torch.raster import aa

    if scaled is None:
        return 0
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    rows, ss, ee = (np.asarray(a, np.int64) for a in scaled)
    tw = 16 * w + 16
    cs, ce = np.clip(ss - (16 * x0 - 32), 0, tw), np.clip(ee + 1 - (16 * x0 - 32), 0, tw)
    band_h = max(1, aa._BAND_SAMPLES // (16 * (tw + 1)) - 1)
    mixed = 0
    for by in range(0, h, band_h):
        bh = min(band_h, h - by)
        r = rows - (16 * (y0 + by) - 32)
        t = aa.mask_of_spans(1, 16 * bh + 16, tw, np.zeros_like(r), r, cs, ce, device)[0]
        q = t.reshape(bh + 1, 16, w + 1, 16).sum((1, 3), dtype=torch.int32)
        n = q[:-1, :-1] + q[:-1, 1:] + q[1:, :-1] + q[1:, 1:]
        mixed += int(((n > 0) & (n < 1024)).sum())
    return mixed


def sprite_span_reads(lists) -> int:
    """The spans a launch over `lists` reads: each unit's band ranges of
    its three families, each span once a unit."""
    import numpy as np

    b = lists.bands[lists.units[:, 3]].astype(np.int64)
    return int((b[:, 1:6:2] - b[:, 0:6:2]).sum())


def sprite_bound(lists, fringe: int, mixed=None) -> dict:
    """What SR1 must do for `lists`: its lists read once (the staged arrays'
    bytes) and its outputs written once (a mask byte, a minshape byte and
    16 bytes of RGBA a pixel; 4 bytes of opacity in opacity mode), over
    HBM_BYTES_PER_S; and its operations, 1024 multiply-adds (two int32
    operations each) at each of `fringe` pixels, at INT_OPS_PER_S.  The
    bound is the larger.  In opacity mode `fringe` is every pixel of the
    box and `mixed` the pixels whose footprint is mixed (mixed_pixels): the
    bound counts the multiply-adds at those alone, the least work, and
    bound_all_pixels_ms at every pixel beside it (the first design's count)."""
    import numpy as np

    list_bytes = sum(a.nbytes for a in (lists.spans, lists.bands, lists.fills, lists.members, lists.units))
    pixels = int((lists.members[:, 0].astype(np.int64) * lists.members[:, 1]).sum())
    n_bytes = list_bytes + (4 if lists.opacity else 18) * pixels
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    counted = fringe if mixed is None else mixed
    ops = 2 * 1024 * counted
    ops_ms = ops / INT_OPS_PER_S * 1e3
    row = {"list_bytes": list_bytes, "pixels": pixels, "bytes": n_bytes, "fringe_pixels": fringe, "operations": ops,
           "bound_ms": max(byte_ms, ops_ms), "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}
    if mixed is not None:
        row["mixed_pixels"] = mixed
        row["bound_all_pixels_ms"] = max(byte_ms, 2 * 1024 * fringe / INT_OPS_PER_S * 1e3)
    return row


def sprite_raster_row(torch, dev, scrub, groups=None, matte=None) -> dict:
    """SR1 in group mode over `groups`' members (one launch) or in opacity
    mode over one `matte` (box, scaled), against its plain version on the
    card (_raster_members over each group's sub-batches, or
    coverage_opacity_torch), bit for bit, with its bound (sprite_bound; a
    matte's at its mixed pixels, mixed_pixels) and the spans a launch reads
    (span_reads, sprite_span_reads).
    The kernel alone on lists staged beforehand (ms: CUDA events, cold L2,
    behind a device-side wait of max(ANIMATED_WAIT_MS, 4 x its slowest host
    call), each call queued within half of it, H42); the staged copy alone
    (copy_ms, behind a wait made alike from the copy's host time); the
    plain version over N_BRUSH_PLAIN_TIMED calls; the
    wrapper's whole host side (host_ms: packing, staged copy, launch); one
    call of the wrapper's issued launches and copies, required to be two;
    the units, spans, blocks an SM."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import aa
    from coherence_tpu_torch.scene import fastframe
    from profile_general import issued

    if groups is not None:
        ordered = [m for members in groups.values() for m in members]
        lists = kernels.sprite_raster_lists([(m.x0, m.y0, m.w, m.h) for m in ordered], [m.fill for m in ordered],
                                            [m.cov for m in ordered], [m.cross for m in ordered],
                                            [m.aa for m in ordered])

        def plain():
            return [p for members in groups.values() for run in fastframe._sub_batches(members)
                    for p in zip(*fastframe._raster_members(run, dev))]

        def wrapper():
            return fastframe._sprite_raster_members(ordered, dev)
    else:
        box, scaled = matte
        lists = kernels.sprite_opacity_lists(box, scaled)

        def plain():
            return aa.coverage_opacity_torch(box, scaled, dev)

        def wrapper():
            return kernels.sprite_raster_opacity(box, scaled, dev)

    staged = kernels.stage_sprite_lists(lists, dev)

    def kernel():
        return kernels.sprite_raster(lists, staged)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if groups is not None:
        require(len(got) == len(want), "sprite_raster: not one plane triple a member")
        for j, (g, w) in enumerate(zip(got, want)):
            require(all(torch.equal(a, b) and a.is_contiguous() and a.data_ptr() % 16 == 0 for a, b in zip(g, w)),
                    f"sprite_raster: member {j} differs from its plain version")
        fringe = sum(int((mask & ~minmask).sum()) for mask, minmask, _ in want)
        err = max(max_abs_err(g[2], w[2]) for g, w in zip(got, want))
        shape = {"members": len(ordered), "groups": len(groups)}
    else:
        require(torch.equal(got, want), f"sprite_raster's matte over {box} differs from its plain version")
        fringe, err = got.numel(), max_abs_err(got, want)
        shape = {"box": list(box), "aa_spans": 0 if scaled is None else len(scaled[0])}
    n_issued = issued(torch, wrapper)
    require(n_issued == 2, f"one sprite_raster call issued {n_issued} launches and copies, not 2")
    mixed = None if groups is not None else mixed_pixels(torch, box, scaled, dev)
    row = {**shape, "units": len(lists.units), "spans": len(lists.spans), "span_reads": sprite_span_reads(lists),
           "max_abs_err": err, "blocks_per_sm": kernels.sprite_raster_blocks_per_sm(), "issued": n_issued,
           **sprite_bound(lists, fringe, mixed), **fold_host_ms(torch, wrapper)}
    def copy():
        return kernels.stage_sprite_lists(lists, dev)

    row["wait_ms"] = max(ANIMATED_WAIT_MS, 4 * fold_host_ms(torch, kernel)["host_ms_max"])
    row["ms"] = event_ms(torch, kernel, scrub, wait_ms=row["wait_ms"], queued=True)
    row["copy_wait_ms"] = max(ANIMATED_WAIT_MS, 4 * fold_host_ms(torch, copy)["host_ms_max"])
    row["copy_ms"] = event_ms(torch, copy, scrub, wait_ms=row["copy_wait_ms"], queued=True)
    row["plain_ms"] = event_ms(torch, plain, scrub, reps=N_BRUSH_PLAIN_TIMED)
    row["share"] = row["bound_ms"] / row["ms"]
    return row


def sprite_kernels(torch, dev, kernels, scrub, floor_ms: float) -> dict:
    """SR1 at general_lion's rebuild (sprite_inputs): its batched members
    in one launch, and each scalar member's matte, then the H61 matte
    (h61_matte, past the first design's packing), by sprite_raster_row,
    uncounted.  Returns the kernels line's row: the batched members', each
    matte's beside it."""
    def rows():
        inputs = sprite_inputs(torch, dev)
        return (sprite_raster_row(torch, dev, scrub, groups=inputs["groups"]),
                [sprite_raster_row(torch, dev, scrub, matte=m) for m in (*inputs["mattes"], h61_matte())])

    group, mattes = uncounted(kernels, rows)
    for row in (group, *mattes):
        row["launch_floor_ms"] = floor_ms
    emit({"phase": "sprite_kernels", "tolerance": 0, "equal_plain": True, "lion_members": group, "mattes": mattes})
    keys = ("box", "units", "spans", "span_reads", "fringe_pixels", "mixed_pixels", "ms", "copy_ms", "plain_ms",
            "host_ms", "bound_ms", "bound_all_pixels_ms", "bound_by", "bytes", "share")
    return {**group, "max_abs_err": max([group["max_abs_err"]] + [m["max_abs_err"] for m in mattes]),
            "mattes": [{k: m[k] for k in keys} for m in mattes]}


@contextlib.contextmanager
def recorded_region_calls():
    """Inside, every call of the card routes of the region programs
    appends its arguments to the yielded dict's list of its kernel, then
    runs as before: region._caf_card (op, pred, a, b), kernels.tight_bounds
    (mask, word), kernels.box_morph (mask, rx, ry, erode) and
    kernels.convolve_canvas (kind, weights, total, radius, canvas, mask)."""
    from coherence_tpu_torch import kernels
    from coherence_tpu_torch.raster import region

    calls = {name: [] for name in REGION_KERNELS}
    owners = {"caf": (region, "_caf_card"), "tight_bounds": (kernels, "tight_bounds"),
              "box_morph": (kernels, "box_morph"), "convolve_canvas": (kernels, "convolve_canvas")}
    real = {name: getattr(*owner) for name, owner in owners.items()}

    def recording(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)

        return call

    for name, (owner, attr) in owners.items():
        setattr(owner, attr, recording(name))
    try:
        yield calls
    finally:
        for name, (owner, attr) in owners.items():
            setattr(owner, attr, real[name])


def region_inputs(torch, dev) -> tuple:
    """The region kernels' calls in general_filters' frames on `dev`
    (recorded_region_calls): the whole-window render of the filter scene
    and its first dragged frame's incremental render, which ends in the caf
    of the patch over the last frame; and that frame."""
    from coherence_tpu_torch.scene import cache

    lens, blob, objs = filter_scene()
    with recorded_region_calls() as calls:
        frames, _ = filter_frames(torch, dev, lens, blob, objs, 1, scratch=0, whole=False)
    cache.clear()
    return calls, frames[-1]


def tensor_sectors(torch, t) -> int:
    """The 32-byte sectors holding the elements of `t`, a view with any
    strides (an expanded plane's repeated elements once)."""
    if t.is_contiguous():
        first = t.data_ptr()
        return -(-(first + t.numel() * t.element_size()) // SECTOR_BYTES) - first // SECTOR_BYTES
    offsets = torch.zeros((), dtype=torch.int64, device=t.device)
    for size, stride in zip(t.shape, t.stride()):
        offsets = offsets[..., None] + torch.arange(size, dtype=torch.int64, device=t.device) * stride
    return int(torch.unique((t.data_ptr() + offsets.flatten() * t.element_size()) // SECTOR_BYTES).numel())


def region_bound(torch, reads, out_bytes: int, ops: int = 0) -> dict:
    """A region kernel's bound: the sectors of each plane in `reads` read
    once and `out_bytes` of new contiguous planes written once, over
    HBM_BYTES_PER_S; its int32 operations at INT_OPS_PER_S; the larger."""
    n_bytes = sum(tensor_sectors(torch, t) for t in reads) * SECTOR_BYTES + out_bytes
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": ops, "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}


def region_row(torch, scrub, kernel, plain, bound: dict, library=None, **shape) -> dict:
    """One shape of a region kernel: `kernel` (the card route's call, as
    the path makes it) timed with event_ms (cold L2, behind a device-side
    wait of max(ANIMATED_WAIT_MS, 4 x its slowest host call), each call
    queued within half of it), `plain` over N_BRUSH_PLAIN_TIMED calls,
    `library` (one PyTorch call of the same function, or None), beside
    the bound and its share."""
    row = {**shape, **bound, "wait_ms": max(ANIMATED_WAIT_MS, 4 * fold_host_ms(torch, kernel)["host_ms_max"])}
    row["ms"] = event_ms(torch, kernel, scrub, wait_ms=row["wait_ms"], queued=True)
    row["plain_ms"] = event_ms(torch, plain, scrub, reps=N_BRUSH_PLAIN_TIMED)
    row["library_ms"] = None if library is None else event_ms(torch, library, scrub)
    row["share"] = row["bound_ms"] / row["ms"]
    return row


def same_caf(torch, got, want) -> bool:
    (gs, gf), (ws, wf) = got, want
    return same_sprite(torch, gs, ws) and gf.box == wf.box and torch.equal(gf.mask, wf.mask)


def conv_kernel(kind: str, weights, total: int, radius: int):
    """raster/convolve.py's kernel of CV1's arguments."""
    from coherence_tpu_torch.raster import convolve

    if kind == "unit":
        return convolve.UnitKernel(radius)
    if kind == "xy":
        return convolve.XYKernel(radius, total, tuple(weights))
    n = 2 * radius + 1
    return convolve.FullKernel(radius, total, tuple(tuple(weights[k * n : (k + 1) * n]) for k in range(n)))


def union_wh(args):
    """(w, h) of the union box of a recorded caf's (op, pred, a, b)."""
    from coherence_tpu_torch.raster import region

    boxes = [s.box for s in args[2:] if s is not None]
    return region.box_wh(boxes[0] if len(boxes) == 1 else region.box_union(*boxes))


def caf_timed_calls(torch, dev, calls, last_frame) -> list:
    """The (op, pred, a, b) of the cafs region_kernels times, from
    general_filters' recorded calls: the last frame over a white 1920 x
    1080 window (frame_path's final caf), the largest caf of two operands
    and the median caf."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.raster import fills, region

    by_area = sorted((args for args, _ in calls["caf"]), key=lambda args: union_wh(args)[0] * union_wh(args)[1])
    two = [args for args in by_area if args[2] is not None and args[3] is not None]
    white = region.fillshape(region.shape_of_box(WINDOW, dev), fills.plain(C.white))
    return [("over", "opaque", last_frame, white), two[-1], by_area[len(by_area) // 2]]


# MR1's synthetic call on its second route: a sparse 2400 x 96 mask bloated
# by (3, 900), whose staged reach is past one block's shared memory.
MORPH_SECOND_ROUTE = {"shape": (2400, 96), "density": 0.01, "rx": 3, "ry": 900}


def morph_second_route(torch, dev) -> tuple:
    """((mask, rx, ry), {"erode": False}) of MORPH_SECOND_ROUTE, the mask
    made from a fixed seed on `dev`."""
    import numpy as np

    c = MORPH_SECOND_ROUTE
    mask = torch.from_numpy(np.random.default_rng(23).random(c["shape"]) < c["density"]).to(dev)
    return (mask, c["rx"], c["ry"]), {"erode": False}


def morph_timed_calls(torch, dev, calls) -> list:
    """The ((mask, rx, ry), kw) of the box_morphs region_kernels times: each
    distinct (shape, radii, mode) of general_filters' recorded calls, then
    morph_second_route's."""
    seen, out = set(), []
    for (mask, rx, ry), kw in calls["box_morph"]:
        key = (tuple(mask.shape), rx, ry, kw["erode"])
        if key not in seen:
            seen.add(key)
            out.append(((mask, rx, ry), kw))
    return out + [morph_second_route(torch, dev)]


def bounds_ticket_mask(torch, dev):
    """TB1's synthetic mask, on its ticket route over 270 blocks: a 3840 x
    2160 window's mask (config 5's frame) with 40 cells set (seed 24)."""
    import numpy as np

    rng = np.random.default_rng(24)
    m = np.zeros((2160, 3840), bool)
    m[rng.integers(0, 2160, 40), rng.integers(0, 3840, 40)] = True
    return torch.from_numpy(m).to(dev)


# CV1's radius past the staged route's shared memory: its second route, the two passes.
CONV_SECOND_RADIUS = 23


def conv_second_route(torch, dev, recorded) -> tuple:
    """CV1's arguments on its second route: mkgaussian(CONV_SECOND_RADIUS)
    over the canvas and mask of the smallest recorded convolve (the frame's
    incremental one)."""
    from coherence_tpu_torch.raster import convolve

    args = min((a for a, _ in recorded), key=lambda a: a[4].shape[0] * a[4].shape[1])
    return convolve.card_kernel(convolve.mkgaussian(CONV_SECOND_RADIUS)) + tuple(args[4:])


def region_kernels(torch, dev, kernels, scrub, floor_ms: float) -> dict:
    """CF1, TB1, MR1 and CV1 at general_filters' calls (region_inputs), each
    held bit for bit to its plain version on the card at every recorded
    call, then timed (region_row) at the frame's shapes: caf at the last
    frame over a white 1920 x 1080 window (frame_path's final caf), the
    largest caf of two operands and the median caf; the largest and the
    median tight_bounds mask (on the ticket and one-block routes) and
    bounds_ticket_mask's (270 blocks of the ticket route), each also through
    region._tight_bounds (the mapped host word, its host ms); each distinct
    bloat and erosion; the frames' convolves and config 4's 1088 x 1920 one
    (the staged route) and conv_second_route's (the two passes).  Each row
    names its route.  Uncounted.  Returns the kernels line's rows by
    kernel."""
    from coherence_tpu_torch.raster import convolve, region

    F = torch.nn.functional

    def run():
        calls, last_frame = region_inputs(torch, dev)
        counts = {name: len(c) for name, c in calls.items()}
        for name in REGION_KERNELS:
            require(counts[name] >= 1, f"region_kernels: general_filters' frames made no {name} call")
        errs = dict.fromkeys(REGION_KERNELS, 0)
        for (op, pred, a, b), _ in calls["caf"]:
            got, want = region._caf_card(op, pred, a, b), region.caf_torch(op, pred, a, b)
            require(same_caf(torch, got, want), f"caf {op} over {a and a.box} and {b and b.box} differs from its plain version")
            errs["caf"] = max(errs["caf"], max_abs_err(got[0].rgba, want[0].rgba))
        for (mask, *_), _ in calls["tight_bounds"]:  # (mask, the mapped word) as region._tight_bounds calls it
            got, want = tuple(kernels.tight_bounds(mask).tolist()), region._tight_bounds_torch(mask)
            require(got == want, f"tight_bounds of a {tuple(mask.shape)} mask differs from its plain version")
            errs["tight_bounds"] = max([errs["tight_bounds"]] + [abs(g - w) for g, w in zip(got, want)])
        for (mask, rx, ry), kw in calls["box_morph"]:
            plain = region.erode_torch if kw["erode"] else region.dilate_torch
            got, want = kernels.box_morph(mask, rx, ry, **kw), plain(mask, rx, ry)
            require(torch.equal(got, want),
                    f"box_morph of a {tuple(mask.shape)} mask at ({rx}, {ry}) {kw} differs from its plain version")
            errs["box_morph"] = max(errs["box_morph"], max_abs_err(got, want))
        frame, _ = convolve_frame(torch, dev)
        whole = torch.ones((CONV_H, CONV_W), dtype=torch.bool, device=dev)
        k5 = convolve.mkgaussian(BLUR_RADIUS)
        conv_calls = calls["convolve_canvas"] + [(convolve.card_kernel(k5) + (frame, whole), {})]
        for args, _ in conv_calls:
            got, want = kernels.convolve_canvas(*args), convolve.convolve_canvas_torch(conv_kernel(*args[:4]), *args[4:])
            require(torch.equal(got, want), f"convolve_canvas over {tuple(args[4].shape)} differs from its plain version")
            errs["convolve_canvas"] = max(errs["convolve_canvas"], max_abs_err(got, want))

        rows = {name: [] for name in REGION_KERNELS}
        timed_cafs = caf_timed_calls(torch, dev, calls, last_frame)
        require(same_caf(torch, region._caf_card(*timed_cafs[0]), region.caf_torch(*timed_cafs[0])),
                "caf of the frame over the window differs from its plain version")
        for op, pred, a, b in timed_cafs:
            w, h = union_wh((op, pred, a, b))
            both = a is not None and b is not None
            reads = [t for s in (a, b) if s is not None for t in (s.mask, s.rgba)]
            rows["caf"].append(region_row(
                torch, scrub, lambda: region._caf_card(op, pred, a, b), lambda: region.caf_torch(op, pred, a, b),
                region_bound(torch, reads, (18 if both else 1) * h * w), op=op, union=[h, w],
                operands=[list(s.box) for s in (a, b) if s is not None]))
        masks = sorted((c[0][0] for c in calls["tight_bounds"]), key=lambda m: m.numel())
        for mask, synthetic in ((masks[-1], False), (masks[len(masks) // 2], False), (bounds_ticket_mask(torch, dev), True)):
            got, want = tuple(kernels.tight_bounds(mask).tolist()), region._tight_bounds_torch(mask)
            require(got == want and region._tight_bounds(mask) == want,
                    f"tight_bounds of a {tuple(mask.shape)} mask differs from its plain version")
            route = kernels.tight_bounds_route(*mask.shape, *mask.stride())
            rows["tight_bounds"].append(region_row(
                torch, scrub, lambda: kernels.tight_bounds(mask), lambda: region._tight_bounds_torch(mask),
                region_bound(torch, [mask], 16), mask=list(mask.shape), route=route._asdict(), synthetic=synthetic,
                readback_host_ms=fold_host_ms(torch, lambda: region._tight_bounds(mask))))
        for (mask, rx, ry), kw in morph_timed_calls(torch, dev, calls):
            out = kernels.box_morph(mask, rx, ry, **kw)
            plain = region.erode_torch if kw["erode"] else region.dilate_torch
            want = plain(mask, rx, ry)
            require(torch.equal(out, want),
                    f"box_morph of a {tuple(mask.shape)} mask at ({rx}, {ry}) {kw} differs from its plain version")
            errs["box_morph"] = max(errs["box_morph"], max_abs_err(out, want))
            library = None
            if not kw["erode"]:
                padded = F.pad(mask.to(torch.float16), (rx, rx, ry, ry))[None, None]
                library = lambda: F.max_pool2d(padded, (2 * ry + 1, 2 * rx + 1), stride=1, padding=(ry, rx))
                require(torch.equal(library()[0, 0] > 0, out), "box_morph: max_pool2d's dilation differs from bloat's")
            route = kernels.box_morph_route(*mask.shape, rx, ry, kw["erode"])._asdict()
            rows["box_morph"].append(region_row(
                torch, scrub, lambda: kernels.box_morph(mask, rx, ry, **kw), lambda: plain(mask, rx, ry),
                region_bound(torch, [mask], out.numel()), library, mode="erode" if kw["erode"] else "bloat",
                mask=list(mask.shape), radii=[rx, ry], out=list(out.shape), route=route,
                synthetic=tuple(mask.shape) == MORPH_SECOND_ROUTE["shape"]))
        second = conv_second_route(torch, dev, calls["convolve_canvas"])
        got, want = kernels.convolve_canvas(*second), convolve.convolve_canvas_torch(conv_kernel(*second[:4]), *second[4:])
        require(torch.equal(got, want), f"convolve_canvas at r = {second[3]} differs from its plain version")
        errs["convolve_canvas"] = max(errs["convolve_canvas"], max_abs_err(got, want))
        for args, _ in conv_calls + [(second, {"synthetic": True})]:
            kind, weights, total, r, canvas, mask = args
            H, W = canvas.shape[:2]
            route = kernels.convolve_route(kind, H, W, r)
            taps = (2 * r + 1) ** 2 if kind == "full" else 2 * (2 * r + 1)
            ops = 2 * 4 * taps * int(mask[:H, :W].sum())  # a multiply-add a tap and channel at each masked pixel
            rows["convolve_canvas"].append(region_row(
                torch, scrub, lambda: kernels.convolve_canvas(*args),
                lambda: convolve.convolve_canvas_torch(conv_kernel(*args[:4]), canvas, mask),
                region_bound(torch, [canvas, mask[:H, :W]], 16 * H * W, ops), kind=kind, radius=r,
                canvas=[H, W], route={**route._asdict(), "launches": route.launches},
                synthetic=args is second))
        return counts, rows, errs

    counts, rows, errs = uncounted(kernels, run)
    for name, kernel_rows in rows.items():
        for row in kernel_rows:
            row["launch_floor_ms"] = floor_ms
    emit({"phase": "region_kernels", "tolerance": 0, "equal_plain": True, "calls": counts, "max_abs_err": errs,
          "rows": rows})
    return {name: {"rows": kernel_rows, "calls": counts[name], "max_abs_err": errs[name]}
            for name, kernel_rows in rows.items()}


def layers_path(torch, dev, kernels, scrub):
    """Phase 7: config 2's stack over white through composite_layers,
    counted from zero, then the kernel against its plain version over
    white and over noise.  Returns (launch counts, its row)."""
    from coherence_tpu_torch.raster import compositor as PC
    from coherence_tpu_torch.scene import examples, fastframe

    stack = examples.hsr_layers(HSR_K, HSR_H, HSR_W, device=dev)
    white = fastframe._background((255, 255, 255, 255), HSR_H, HSR_W, dev)
    zero_counts(torch, kernels)
    layered = PC.composite_layers(white, stack)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts["composite_layers"] >= 1, "composite_layers never launched on the layer-stack path")
    want = PC.composite_layers_torch(white, stack)
    noise = torch.randint(-(2**31), 2**31 - 1, (HSR_H, HSR_W), dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    over_noise_k = PC.composite_layers(noise, stack)
    over_noise_p = PC.composite_layers_torch(noise, stack)
    torch.cuda.synchronize()
    require(torch.equal(layered, want), "composite_layers differs from composite_layers_torch over white")
    require(torch.equal(over_noise_k, over_noise_p), "composite_layers differs from composite_layers_torch over noise")
    require(bool((((layered >> 24) & 0xFF) == 255).all()), "the layer stack over white is not opaque")
    row = {"max_abs_err": max(max_abs_err(layered, want), max_abs_err(over_noise_k, over_noise_p)),
           "ms": event_ms(torch, lambda: PC.composite_layers(white, stack), scrub),
           "plain_ms": event_ms(torch, lambda: PC.composite_layers_torch(white, stack), scrub)}
    reads, still_open = layer_walk(torch, stack)
    row.update(bound([(reads, still_open)]))
    emit({"phase": "hsr_layers", "layers": HSR_K, "height": HSR_H, "width": HSR_W, "tolerance": 0,
          "stack_mb": stack.numel() * 4 / 1e6, "launches": counts, "equal_plain_white": True,
          "equal_plain_noise": True, "mean_tile_walk_layers": float(reads.max(1).values.float().mean()), **row})
    return counts, row


def mesh_devices(torch, n: int):
    """n distinct cards where there are as many, else n contiguous bands
    over the cards there are (all on cuda:0 with one card)."""
    count = torch.cuda.device_count()
    if count >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [f"cuda:{i * count // n}" for i in range(n)]


def mesh_4k_path(torch, dev, kernels):
    """Phase 8: config 5 under a 2-band mesh against the unsharded view on
    the same card, counted from zero.  Returns (launch counts, the mesh,
    the unsharded display, its blob key)."""
    from coherence_tpu_torch.parallel import make_mesh
    from coherence_tpu_torch.raster import tiled_scene as T
    from coherence_tpu_torch.scene import fastframe

    mesh = make_mesh(2, mesh_devices(torch, 2))
    scene_caches_clear()
    zero_counts(torch, kernels)
    t0 = time.perf_counter()
    mview, mdisp, mkey, objs = build_interactive(dev, mesh)
    torch.cuda.synchronize()
    mesh_build_s = time.perf_counter() - t0
    scene_caches_clear()
    uview, udisp, ukey, _ = build_interactive(dev)
    require(torch.equal(mdisp.rgba.gather(dev), udisp.rgba), "4K meshed full refresh differs from the unsharded one")
    mview.render(full=True)
    uview.render(full=True)
    torch.cuda.synchronize()
    require(torch.equal(mview.content(dev), uview.frame), "4K render_sharded differs from render_full")

    banded = mview.ts._banded
    state = {"rebuilds": 0, "banded": banded, "bands_under_blob": set()}
    snaps = {}
    band_tiles = mview.ts.ntx * mview.ts.nty // mesh.size

    def mframe(k):
        mdisp.step_animated(mkey, *delta4(k))
        if mview.ts._banded is not state["banded"]:
            state["rebuilds"] += 1
            state["banded"] = mview.ts._banded
        state["bands_under_blob"].update(t // band_tiles for t, _ in mview.ts.pieces[mkey])
        if k == 2:
            snaps["m3"] = mdisp.rgba.gather(dev)

    def uframe(k):
        udisp.step_animated(ukey, *delta4(k))
        if k == 2:
            snaps["u3"] = udisp.rgba.clone()

    m_ms, m_s = timed_frames(torch, mframe, N_FRAMES4)
    u_ms, u_s = timed_frames(torch, uframe, N_FRAMES4)
    require(torch.equal(snaps["m3"], snaps["u3"]), "4K meshed display after 3 frames differs from the unsharded one")
    require(torch.equal(mdisp.rgba.gather(dev), udisp.rgba),
            f"4K meshed display after {N_FRAMES4} frames differs from the unsharded one")
    require(torch.equal(mview.content(dev), uview.frame), "4K meshed content differs from the unsharded one")
    require(state["rebuilds"] == 0, f"the banded atlas was rebuilt {state['rebuilds']} times in the animated loop")
    require(len(state["bands_under_blob"]) == mesh.size, "the blob never crossed the band border")
    t0 = time.perf_counter()
    T.BandedAtlas(mview.ts, mesh)
    torch.cuda.synchronize()
    banded_build_s = time.perf_counter() - t0
    band_bytes = [d[b].numel() * 4 for d in banded.data for b in range(d.shape[0])]
    global_bytes = mview.ts.atlas().numel() * 4

    # One zoom step under the mesh against a fresh unsharded view.
    cur = zoomed(objs, 2.0)
    t0 = time.perf_counter()
    mview.reset_scene(cur, tiled=True)
    mview.render(full=True)
    torch.cuda.synchronize()
    zoom_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    scene_caches_clear()
    fresh = fastframe.DeviceView(W4, H4, atlas_cap=ATLAS_CAP4, device=dev)
    fresh.set_scene(cur, tiled=True)
    fresh.render(full=True)
    torch.cuda.synchronize()
    require(torch.equal(mview.content(dev), fresh.frame), "4K zoom step under the mesh differs from a fresh view")
    require(counts["composite_full_banded"] >= 2, f"composite_full_banded launched {counts['composite_full_banded']}")
    require(counts["composite_dirty_banded"] >= N_FRAMES4 + 1,
            f"composite_dirty_banded launched {counts['composite_dirty_banded']}")
    require(counts["shatter_into"] >= N_FRAMES4 and counts["blur_blend"] >= N_FRAMES4,
            f"the meshed frames did not reach shatter_into and blur_blend: {counts}")
    emit({"phase": "mesh_4k", "width": W4, "height": H4, "bands": mesh.size,
          "devices": [str(d) for d in mesh.devices], "cards": torch.cuda.device_count(),
          "build_s": mesh_build_s, "banded_build_s": banded_build_s, "local_cap": banded.local_cap,
          "band_atlas_bytes": band_bytes, "global_atlas_bytes": global_bytes,
          "meshed": frame_stats(m_ms), "meshed_host_ms_per_frame": m_s / N_FRAMES4 * 1e3,
          "unsharded": frame_stats(u_ms), "unsharded_host_ms_per_frame": u_s / N_FRAMES4 * 1e3,
          "frames": N_FRAMES4, "banded_rebuilds": state["rebuilds"],
          "bands_under_blob_in_loop": sorted(state["bands_under_blob"]),
          "zoom_step_s": zoom_s, "launches": counts, "display_equal_at_frames": [3, N_FRAMES4],
          "render_sharded_equal_full": True, "zoom_equal_fresh": True})
    return counts, mesh, udisp, ukey


def first_band_dirty_tiles(disp, key, step, mesh):
    """The dirty tiles of the animated step `step` staged on the unsharded
    display `disp`, those of the first band of `mesh` they reach only, so
    that every other band is idle."""
    ts = disp.view.ts
    coords, _, _, n_listed = disp.stage_animated(key, *step)[4]
    tiles = {int(coords[2 * j]) * ts.ntx + int(coords[2 * j + 1]) for j in range(n_listed)}
    band_tiles = ts.nty // mesh.size * ts.ntx
    first = min(tiles) // band_tiles
    return {t for t in tiles if t // band_tiles == first}


def dirty_banded_row(torch, view, mesh, tiles, scrub, seed: int) -> dict:
    """composite_dirty_banded on `mesh`'s band lists of `tiles` (dirty tiles
    of the unsharded `view`'s scene, all in one band) over noise made from
    `seed`: against its plain version and against composite_dirty on the
    same tiles, bit for bit, with the idle bands left as they were; then
    timed in turns with composite_dirty (its lists, atlas and frame copied
    onto the dirty band's card), and its plain version's time.  Returns the
    row: its times, unbanded_ms, the walk's bytes and bound."""
    from coherence_tpu_torch.parallel import RowSharded
    from coherence_tpu_torch.raster import staging
    from coherence_tpu_torch.raster import tiled_scene as T

    ts = view.ts
    band_ty = ts.nty // mesh.size
    rows = band_ty * 64
    first = min(tiles) // (band_ty * ts.ntx)
    banded = T._banded_of(ts, mesh)
    bg = RowSharded.scatter(view.background, mesh, rows)
    c, sp, di, n_slots = T.sharded_dirty_lists(ts, view.order, tiles, banded)
    idle = [d for d in range(mesh.size) if (sp[d] == -1).all()]
    require(len(idle) == mesh.size - 1, f"bands {sorted(set(range(mesh.size)) - set(idle))} of tiles "
            f"{sorted(tiles)} are dirty, expected band {first} alone")
    noise = torch.randint(-(2**31), 2**31 - 1, view.frame.shape, dtype=torch.int32,
                          generator=torch.Generator(device=view.frame.device).manual_seed(seed),
                          device=view.frame.device)
    gc, gs, gi, g_slots = ts._dirty_args(view.order, tiles)
    unbanded = noise.clone()
    T.composite_dirty(*staging.stage(ts.device, gc, gs, gi), view.background, unbanded, ts.atlas(), g_slots)
    err = 0
    for g, (dv, b0, b1) in enumerate(mesh.groups):
        cc, ss, ii = (torch.from_numpy(a[b0:b1]).to(dv) for a in (c, sp, di))
        fk = noise[b0 * rows : b1 * rows].to(dv, copy=True)
        fp = fk.clone()
        T.composite_dirty_banded(cc, ss, ii, bg.parts[g], fk, banded.data[g], n_slots)
        T.composite_dirty_banded_torch(cc, ss, ii, bg.parts[g], fp, banded.data[g], n_slots)
        torch.cuda.synchronize()
        require(torch.equal(fk, fp), "composite_dirty_banded differs from composite_dirty_banded_torch")
        require(torch.equal(fk, unbanded[b0 * rows : b1 * rows].to(dv)),
                "composite_dirty_banded differs from composite_dirty on the same tiles")
        for d in idle:
            if b0 <= d < b1:
                r = slice(d * rows, (d + 1) * rows)
                require(torch.equal(fk[(d - b0) * rows : (d - b0 + 1) * rows], noise[r].to(dv)),
                        "composite_dirty_banded changed an idle band")
        err = max(err, max_abs_err(fk, fp))
        if b0 <= first < b1:
            timed = (g, dv, cc, ss, ii, bg.parts[g], banded.data[g], fk, fp)
    # Times on the stack of the card holding the dirty band (the whole frame
    # with one card), with that card's events and its L2 scrubbed.
    g, dv, cc, ss, ii, gbg, atlas, fk, fp = timed
    dscrub = scrub if scrub.device == torch.device(dv) else torch.empty_like(scrub, device=dv)
    uargs = [a.to(dv) for a in staging.stage(ts.device, gc, gs, gi)]
    ubg, uatlas, uframe = view.background.to(dv), ts.atlas().to(dv), noise.to(dv, copy=True)
    with torch.cuda.device(dv):
        row = in_turns(torch, lambda: T.composite_dirty_banded(cc, ss, ii, gbg, fk, atlas, n_slots), dscrub,
                       unbanded=lambda: T.composite_dirty(*uargs, ubg, uframe, uatlas, g_slots))
        row["plain_ms"] = event_ms(
            torch, lambda: T.composite_dirty_banded_torch(cc, ss, ii, gbg, fp, atlas, n_slots), dscrub)
    del dscrub
    fb = first - mesh.groups[g][1]
    walk = bound([walked_depths(torch, atlas[fb], ii[fb], dirty_spans(torch, c[first], sp[first], n_slots, dv))])
    return {"max_abs_err": err, "bands": mesh.size, "slots": n_slots, "dirty_tiles": len(tiles),
            "dirty_band": first, "idle_bands": idle, "timed_device": str(dv), **row, **walk}


def full_banded_row(torch, view, mesh, scrub) -> dict:
    """composite_full_banded on `mesh`'s band lists of the unsharded
    `view`'s scene: against its plain version and against composite_full on
    the same frame, bit for bit, on every card's stack of bands; then timed
    on the first card's stack (the whole frame with one card) in turns with
    composite_full on the whole frame (its lists, atlas and background
    copied onto that card), and its plain version's time.  Returns the row:
    its times, unbanded_ms, the walk's bytes and bound."""
    from coherence_tpu_torch.parallel import RowSharded
    from coherence_tpu_torch.raster import tiled_scene as T

    ts = view.ts
    band_ty = ts.nty // mesh.size
    rows = band_ty * 64
    banded = T._banded_of(ts, mesh)
    bg = RowSharded.scatter(view.background, mesh, rows)
    starts, idxs = T.sharded_lists(ts, view.order, banded)
    g_starts, g_idxs = ts.build_lists(view.order)
    unbanded = T.composite_full(g_starts, g_idxs, view.background, ts.atlas(), ts.nty, ts.ntx)
    err = 0
    for g, (dv, b0, b1) in enumerate(mesh.groups):
        s, i = (torch.from_numpy(a[b0:b1]).to(dv) for a in (starts, idxs))
        k = T.composite_full_banded(s, i, bg.parts[g], banded.data[g], band_ty, ts.ntx)
        p = T.composite_full_banded_torch(s, i, bg.parts[g], banded.data[g], band_ty, ts.ntx)
        torch.cuda.synchronize()
        require(torch.equal(k, p), "composite_full_banded differs from composite_full_banded_torch")
        require(torch.equal(k, unbanded[b0 * rows : b1 * rows].to(dv)),
                "composite_full_banded differs from composite_full")
        err = max(err, max_abs_err(k, p))
    dv, b0, b1 = mesh.groups[0]
    s, i = (torch.from_numpy(a[b0:b1]).to(dv) for a in (starts, idxs))
    gbg, atlas = bg.parts[0], banded.data[0]
    us, ui, ubg, uatlas = (x.to(dv) for x in (g_starts, g_idxs, view.background, ts.atlas()))
    dscrub = scrub if scrub.device == torch.device(dv) else torch.empty_like(scrub, device=dv)
    with torch.cuda.device(dv):
        row = in_turns(torch, lambda: T.composite_full_banded(s, i, gbg, atlas, band_ty, ts.ntx), dscrub,
                       unbanded=lambda: T.composite_full(us, ui, ubg, uatlas, ts.nty, ts.ntx))
        row["plain_ms"] = event_ms(torch, lambda: T.composite_full_banded_torch(s, i, gbg, atlas, band_ty, ts.ntx),
                                   dscrub)
    del dscrub
    walk = bound([walked_depths(torch, atlas[k], i[k], full_spans(torch, s[k])) for k in range(atlas.shape[0])])
    return {"max_abs_err": err, "bands": mesh.size, "band_tiles": band_ty * ts.ntx,
            "listed_pieces": int(starts[:, -1].sum()), "local_cap": banded.local_cap,
            "global_slots": int(ts.atlas().shape[0]), "timed_device": str(dv), "timed_stack_bands": b1 - b0,
            **row, **walk}


def mesh_kernels(torch, scrub, mesh, udisp, ukey):
    """Phase 9: composite_full_banded and composite_dirty_banded on config
    5's 2-band lists (the 1x scene of phase 8's unsharded view, blob
    moved), each against its plain version and timed in turns with its
    unbanded kernel.  Returns {kernel: row}."""
    full = full_banded_row(torch, udisp.view, mesh, scrub)
    # The dirty tiles of the next animated step, those of its first band
    # only, so that another band is idle.
    dirty = dirty_banded_row(torch, udisp.view, mesh, first_band_dirty_tiles(udisp, ukey, delta4(0), mesh), scrub, 2)
    emit({"phase": "mesh_kernels", "tolerance": 0, "bands": mesh.size, "devices": [str(d) for d in mesh.devices],
          "composite_full_banded": {"equal_plain": True, "equal_composite_full": True, **full},
          "composite_dirty_banded": {"equal_plain": True, "equal_composite_dirty": True, **dirty}})
    return {"composite_full_banded": full, "composite_dirty_banded": dirty}


def mesh_lion_path(torch, dev, kernels, scrub):
    """Phase 10: the lion on 17 bands (one tile row each), a full render
    and N_CHECK filtered frames against the unsharded lion, counted from
    zero; then composite_dirty_banded on the 17-band lists of the next
    step's dirty tiles in one band (16 idle bands) against composite_dirty
    on the same tiles, and composite_full_banded on the 17-band full-frame
    lists against composite_full.  Returns (the launch counts, the
    composite_dirty_banded row, the composite_full_banded row)."""
    from coherence_tpu_torch.parallel import make_mesh

    mesh = make_mesh(17, mesh_devices(torch, 17))
    zero_counts(torch, kernels)
    mview, mdisp, mkey = build_scene(dev, mesh)
    uview, udisp, ukey = build_scene(dev)
    require(torch.equal(mdisp.rgba.gather(dev), udisp.rgba), "17-band lion full refresh differs")
    mview.render(full=True)
    uview.render(full=True)
    require(torch.equal(mview.content(dev), uview.frame), "17-band lion render_sharded differs from render_full")
    for k in range(N_CHECK):
        mdisp.step_animated(mkey, *delta(k))
        udisp.step_animated(ukey, *delta(k))
    torch.cuda.synchronize()
    require(torch.equal(mdisp.rgba.gather(dev), udisp.rgba), f"17-band lion display after {N_CHECK} frames differs")
    require(torch.equal(mview.content(dev), uview.frame), f"17-band lion content after {N_CHECK} frames differs")
    counts = dict(kernels.launches)
    require(counts["composite_dirty_banded"] >= N_CHECK + 1,
            f"composite_dirty_banded launched {counts['composite_dirty_banded']} times on the 17-band lion")
    require(counts["composite_full_banded"] >= 1,
            f"composite_full_banded launched {counts['composite_full_banded']} times on the 17-band lion")
    require(counts["shatter_into"] >= N_CHECK and counts["blur_blend"] >= N_CHECK,
            f"the 17-band lion's frames did not reach shatter_into and blur_blend: {counts}")
    band_rows = {t // mview.ts.ntx for t, _ in mview.ts.pieces[mkey]}
    dirty = dirty_banded_row(torch, uview, mesh, first_band_dirty_tiles(udisp, ukey, delta(N_CHECK), mesh), scrub, 3)
    full = full_banded_row(torch, uview, mesh, scrub)
    emit({"phase": "mesh_lion", "width": W, "height": H, "bands": mesh.size, "devices": sorted({str(d) for d in
                                                                                          mesh.devices}),
          "frames": N_CHECK, "display_equal": True, "full_render_equal": True,
          "bands_under_the_blob_at_end": sorted(band_rows), "launches": counts,
          "composite_dirty_banded": {"tolerance": 0, "equal_plain": True, "equal_composite_dirty": True, **dirty},
          "composite_full_banded": {"tolerance": 0, "equal_plain": True, "equal_composite_full": True, **full}})
    return counts, dirty, full


def play_path(torch, dev, kernels):
    """Phase 11: the lion's play_animated over N_FRAMES deltas (staged on
    the host first, then three launches a step: shatter_into,
    composite_dirty, blur_blend) against N_FRAMES step_animated calls on a
    second view, in turns (steps, play, play, steps; the deltas return the
    blob to its start), each timed.  Returns the launches of one
    play_animated call."""
    deltas = [delta(k) for k in range(N_FRAMES)]
    pview, pdisp, pkey = build_scene(dev)
    sview, sdisp, skey = build_scene(dev)

    def steps():
        for d in deltas:
            sdisp.step_animated(skey, *d)

    play_counts = {}

    def play():
        before = dict(kernels.launches)
        pdisp.play_animated(pkey, deltas, require_scan=True)
        play_counts.update({k: n - before[k] for k, n in kernels.launches.items() if n != before[k]})

    times = {"play": [], "steps": []}
    for name, fn in (("steps", steps), ("play", play), ("play", play), ("steps", steps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / N_FRAMES * 1e3)
        if len(times["play"]) == len(times["steps"]):
            require(torch.equal(pdisp.rgba, sdisp.rgba), f"play_animated differs from {N_FRAMES} step_animated calls")
            require(torch.equal(pview.frame, sview.frame), "play_animated content differs from step_animated's")
    want = {"shatter_into": N_FRAMES, "composite_dirty": N_FRAMES, "blur_blend": N_FRAMES}
    require(play_counts == want, f"play_animated launched {play_counts}, not {want}")
    emit({"phase": "play_animated", "frames": N_FRAMES, "require_scan": True, "equal_sequential": True,
          "order": "steps, play, play, steps", "ms_per_frame": times["play"],
          "sequential_ms_per_frame": times["steps"], "launches_per_play": play_counts})
    return play_counts


def animated_chain(torch, dev, kernels) -> dict:
    """The animated frame with its launches queued ahead of the card
    (profile_frame.queued_chain: frames behind one device-side wait, each
    rep's display and content equal, bit for bit, to a second scene's
    stepped one frame at a time): the lion's steady step_animated (one
    staged copy, shatter_into, composite_dirty, blur_blend) and config 5's
    filtered frame.  There programmatic dependent launch starts
    composite_dirty as shatter_into ends and blur_blend as composite_dirty
    ends.  Every frame of either scene launches each of the
    three once.  Returns {"lion": chain, "config5": chain}."""
    from profile_frame import queued_chain

    this = sys.modules[__name__]
    rows = {}
    for name, build, frame in (
            ("lion", lambda: build_scene(dev), lambda st, k: st[1].step_animated(st[2], *delta(k))),
            ("config5", lambda: build_interactive(dev), lambda st, k: filtered_frame(st[0], st[1], st[2], k))):
        state, reference = build(), build()
        zero_counts(torch, kernels)
        rows[name] = queued_chain(torch, this, frame, state, reference)
        counts = dict(kernels.launches)
        frames = 2 * rows[name]["frames"] * rows[name]["passes"]  # both scenes, the untimed passes and retakes included
        want = {"shatter_into": frames, "composite_dirty": frames, "blur_blend": frames}
        require({k: counts[k] for k in want} == want, f"{name}'s chain launched {counts}, not {want}")
        del state, reference
        gc.collect()
    emit({"phase": "animated_chain", "tolerance": 0, **rows})
    return rows


# ---------------------------------------------------------------------------
# The general renderer (render_simple_scene, render_scene, the coherence
# cache, the filters): torch ops on the device, no hand-written kernel.
# ---------------------------------------------------------------------------

WINDOW = (1, 1, W, H)
GENERAL_FIT = 1024  # benchmarks/run.py config 1 fits the lion to 512; its full size is 1024
GENERAL_CACHE_BYTES = 4 * 2**30
N_GENERAL_FRAMES = 10
N_GENERAL_CPU_FRAMES = 2
N_GENERAL_SCRATCH_FRAMES = 1  # frames also rendered with the cache off
DEMO_LION_STRIDE = 4  # the filter demos lie over every fourth path of the lion, on the card and on the CPU
CONV_H, CONV_W, CONV_CALLS = 1088, 1920, 30  # benchmarks/run.py config 4
# The hand-written kernels of the general renderer's region programs (CF1, TB1, MR1, CV1).
REGION_KERNELS = ("caf", "tight_bounds", "box_morph", "convolve_canvas")
# The kernels the general renderer launches; any other is a tile kernel.
GENERAL_KERNELS = ("fold_layers", "sprite_raster") + REGION_KERNELS


def same_sprite(torch, a, b) -> bool:
    """Two sprites, on any devices: equal in box, mask and colours."""
    if a is None or b is None:
        return a is None and b is None
    return (a.box == b.box and torch.equal(a.mask.cpu(), b.mask.cpu())
            and torch.equal(a.rgba.cpu(), b.rgba.cpu()))


def measured(torch, device, fn):
    """fn() with the renderer's counters zeroed before and read after:
    (result, {host ms after a synchronize, CUDA-event ms, objects visited,
    early exits, host syncs counted in raster/region.py, cache bytes})."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.utils import profiling

    on_card = str(device) != "cpu"
    profiling.reset()
    region.syncs = 0
    if on_card:
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        e1.record()
        torch.cuda.synchronize()
    stats = {"host_ms": (time.perf_counter() - t0) * 1e3,
             "objects_visited": profiling.counters["render.objects_visited"],
             "early_exit": profiling.counters["render.early_exit"],
             "syncs": region.syncs, "cache_bytes": cache.properties.cachesize}
    if on_card:
        stats["event_ms"] = e0.elapsed_time(e1)
    return out, stats


def fitted_lion():
    """Config 1's scene: the lion as one Group, fitted to GENERAL_FIT
    pixels and flipped upright, as benchmarks/run.py fits it to 512."""
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import examples
    from coherence_tpu_torch.scene import render as R

    lion = examples.smalllion()
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(lion)
    scale = float(GENERAL_FIT) / max(xmax - xmin, ymax - ymin)
    return R.transform_renderobject_many(
        [tr.Translate(0.0, float(GENERAL_FIT)), tr.Scale((0.0, 0.0), 1.0, -1.0),
         tr.Scale((0.0, 0.0), scale, scale), tr.Translate(-xmin, -ymin)], lion)


def fresh_cache():
    from coherence_tpu_torch.scene import cache

    cache.clear()
    cache.usecache = True
    cache.setsize(GENERAL_CACHE_BYTES)


def issued_rebuild(torch, render):
    """The launches and copies the host issues for one render after
    cache.clear(), counted under the profiler as profile_general.py counts
    them (the runtime's rows)."""
    from coherence_tpu_torch.scene import cache
    from profile_general import issued

    cache.clear()
    return issued(torch, render)


def general_lion(torch, dev, kernels):
    """Config 1 at full size: cold render, rebuild after cache.clear(), warm
    render, on the default route (each group's members through the batched
    raster and one fold_layers launch), then one more rebuild on the
    per-member fold route; all equal, and equal to the CPU's render of the
    same scene.  Returns the fold_layers launches of the cold, rebuilt and
    warm renders, and the group's fold in the CPU's render (its arguments,
    for fold_kernel)."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import flags

    require(flags.get("batch_group_raster"), "general_lion: the batched group route is not the default")
    fresh_cache()
    obj = fitted_lion()
    n_objs = len(obj.geometry.objects)
    predicted = predicted_sprite_launches(lion_members(dev))
    shape = region.shape_of_box(WINDOW, dev)
    render = lambda: R.render_simple_scene([obj], shape, dev)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch, kernels)
    cold, cold_stats = measured(torch, dev, render)
    cache.clear()
    before = dict(kernels.launches)
    rebuilt, rebuild_stats = measured(torch, dev, render)
    rebuild_stats["fold_layers_launches"] = kernels.launches["fold_layers"] - before["fold_layers"]
    rebuild_stats["sprite_raster_launches"] = kernels.launches["sprite_raster"] - before["sprite_raster"]
    rebuild_stats["region_launches"] = {k: kernels.launches[k] - before[k] for k in REGION_KERNELS}
    warm, warm_stats = measured(torch, dev, render)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    rebuild_stats["issued"] = issued_rebuild(torch, render)
    flags.set_flag("batch_group_raster", False)
    try:
        cache.clear()
        before = dict(kernels.launches)
        folded, fold_stats = measured(torch, dev, render)
        fold_stats["fold_layers_launches"] = kernels.launches["fold_layers"] - before["fold_layers"]
        fold_stats["sprite_raster_launches"] = kernels.launches["sprite_raster"] - before["sprite_raster"]
        fold_stats["region_launches"] = {k: kernels.launches[k] - before[k] for k in REGION_KERNELS}
        fold_stats["issued"] = issued_rebuild(torch, render)
    finally:
        flags.set_flag("batch_group_raster", True)
    require(cold is not None and cold.box[2] <= W and cold.box[3] <= H, "the lion rendered outside the window")
    require(same_sprite(torch, cold, rebuilt), "general_lion: the rebuilt render differs from the cold one")
    require(same_sprite(torch, cold, warm), "general_lion: the warm render differs from the cold one")
    require(same_sprite(torch, cold, folded), "general_lion: the per-member fold route differs from the batched route")
    require(bool((cold.rgba[..., 3] == 255).sum() > GENERAL_FIT * GENERAL_FIT // 10), "general_lion: the lion is not there")
    require(rebuild_stats["objects_visited"] == 1 and rebuild_stats["fold_layers_launches"] == 1,
            "general_lion: the rebuild did not render the group through the batched raster and one fold")
    require(fold_stats["objects_visited"] == n_objs + 1 and fold_stats["fold_layers_launches"] == 0,
            "general_lion: the fold route did not visit the group and each of its objects once")
    require(warm_stats["objects_visited"] == 1, "general_lion: the warm render did not come from the group's cached sprite")
    require(rebuild_stats["sprite_raster_launches"] == predicted["launches"],
            f"general_lion: the rebuild launched sprite_raster {rebuild_stats['sprite_raster_launches']} times, not "
            f"{predicted['launches']} (its batched members in one launch and one a scalar member's matte)")
    cache.clear()
    with recorded_folds() as folds:
        on_cpu, cpu_stats = measured(torch, "cpu", lambda: R.render_simple_scene([obj], region.shape_of_box(WINDOW, "cpu"), "cpu"))
    require(len(folds) == 1, f"general_lion: the CPU's render folded {len(folds)} times, not once for the group")
    require(same_sprite(torch, cold, on_cpu), "general_lion: the card's render differs from the CPU's")
    require(cpu_stats["syncs"] == rebuild_stats["syncs"], "general_lion: the CPU render took other branches")
    cache.clear()
    emit({"phase": "general_lion", "window": list(WINDOW), "fit": GENERAL_FIT, "objects": n_objs,
          "box": list(cold.box), "cold": cold_stats, "rebuild": rebuild_stats, "warm": warm_stats,
          "rebuild_fold_route": fold_stats, "cpu": cpu_stats, "launches": counts, "sprite_raster_predicted": predicted,
          "cache_max_bytes": GENERAL_CACHE_BYTES, "peak_device_bytes": peak,
          "equal": {"tolerance": 0, "cold_rebuild_warm": True, "fold_route": True, "cpu": True}})
    counts["sprite_raster_rebuild"] = rebuild_stats["sprite_raster_launches"]
    counts["sprite_raster_fold_route"] = fold_stats["sprite_raster_launches"]
    counts["region_rebuild"], counts["region_fold_route"] = rebuild_stats["region_launches"], fold_stats["region_launches"]
    return counts, folds[0]


def filter_scene():
    """The bench.py scene for the general renderer: a radius-5 blur lens
    over F_BOX on top, the translucent blob beneath it, then the lion's
    objects.  Returns (lens, blob, lion objects)."""
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import examples, filters
    from coherence_tpu_torch.scene import render as R

    objs, blob, f_geom = examples.bench_scene(W, H, blob_radius=60, blob_at=(120, 400), f_box=F_BOX)
    lens = R.Obj(ident.new_ids(), filters.blur(f_geom.geometry, convolve.mkgaussian(BLUR_RADIUS)), (), R.OVER)
    return lens, blob, objs


def filter_frames(torch, device, lens, blob, objs, n: int, scratch: int, whole: bool = True, issued_out=None):
    """n frames of the blob dragged under the lens on `device`.  Each frame
    renders the dirty region (dirty_region carried up through the lens by
    dirty_filter) over the previous frame, and (if `whole`) the whole
    window; the first `scratch` frames also the whole window with the cache
    off (a rebuild of every object each), held equal to both.  Returns
    (frames, per-frame stats).  With a dict `issued_out`, one frame more is
    rendered after them, its incremental render and the whole-window render
    after it each counted by profile_general.issued into it
    ("incremental", "whole"), and held equal."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from profile_general import issued

    fresh_cache()
    master = region.shape_of_box(WINDOW, device)
    frame = R.render_simple_scene([lens, blob] + objs, master, device)
    frames, stats = [], []

    def incremental_of(moved, scene, blob, frame):
        def incremental():
            d = R.dirty_filter(moved.idset, R.dirty_region(blob, moved, device)(master), scene, device)
            patch, _, _ = R.render_scene(moved.idset, False, (d, None), scene, scene, master, device)
            return region.caf("over", "opaque", patch, region.portion(frame, region.shape_difference(master, d)))[0]

        return incremental

    for k in range(n):
        moved = R.translate_renderobject(*delta(k * 40), blob)  # (7, 3) for 5 frames, then back
        scene = [lens, moved] + objs
        incremental = incremental_of(moved, scene, blob, frame)
        frame, inc = measured(torch, device, incremental)
        full = None
        if whole:
            rendered, full = measured(torch, device, lambda: R.render_simple_scene(scene, master, device))
            require(same_sprite(torch, frame, rendered), f"general_filters: frame {k} differs from the whole-window render")
        if k < scratch:
            cache.usecache = False
            try:
                off = R.render_simple_scene(scene, master, device)
            finally:
                cache.usecache = True
            require(same_sprite(torch, frame, off), f"general_filters: frame {k} differs from the cache-off render")
        frames.append(frame)
        stats.append({"incremental": inc, "whole": full})
        blob = moved
    if issued_out is not None:
        from coherence_tpu_torch import kernels

        moved = R.translate_renderobject(*delta(n * 40), blob)
        scene = [lens, moved] + objs
        incremental, got = incremental_of(moved, scene, blob, frame), {}
        for part, fn in (("incremental", incremental), ("whole", lambda: R.render_simple_scene(scene, master, device))):
            before = dict(kernels.launches)
            issued_out[part] = issued(torch, lambda: got.setdefault(part, fn()))
            issued_out[part + "_launches"] = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        require(same_sprite(torch, got["incremental"], got["whole"]),
                "general_filters: the counted frame differs from the whole-window render")
    return frames, stats


def general_filters(torch, dev, kernels):
    """The lion under a blur lens with the blob dragged beneath it, then one
    render of each other filter demo, of the CPG demo and of the two brush
    demos, against the CPU.  Returns the launches of the lens frames on the
    card, and those of the demos' card renders by demo (brush_stamp for the
    brushes, smear_walk for the smear)."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache, examples
    from coherence_tpu_torch.scene import render as R

    lens, blob, objs = filter_scene()
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    frames, stats = filter_frames(torch, dev, lens, blob, objs, N_GENERAL_FRAMES, scratch=N_GENERAL_SCRATCH_FRAMES)
    t1 = time.perf_counter()
    frame_launches = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
    for name in REGION_KERNELS:
        require(frame_launches.get(name, 0) >= 1, f"general_filters: {name} was not launched in the frames")
    # The launches and copies issued by a steady incremental frame (frame 4, as profile_general.py --filters
    # counts it) and by the whole-window render after it, with each kernel's launches in them.
    counted = {}
    filter_frames(torch, dev, lens, blob, objs, 4, scratch=0, whole=False, issued_out=counted)
    t1b = time.perf_counter()
    cpu_frames, _ = filter_frames(torch, "cpu", lens, blob, objs, N_GENERAL_CPU_FRAMES, scratch=0, whole=False)
    t2 = time.perf_counter()
    for k, (a, b) in enumerate(zip(frames, cpu_frames)):
        require(same_sprite(torch, a, b), f"general_filters: frame {k} differs from the CPU's")
    emit({"phase": "general_filters", "frames": N_GENERAL_FRAMES, "f_box": list(F_BOX), "blur_radius": BLUR_RADIUS,
          "incremental": frame_stats([s["incremental"]["event_ms"] for s in stats]),
          "whole_window": frame_stats([s["whole"]["event_ms"] for s in stats]),
          "incremental_host_ms": frame_stats([s["incremental"]["host_ms"] for s in stats]),
          "syncs_per_incremental_frame": statistics.median(s["incremental"]["syncs"] for s in stats),
          "syncs_per_whole_render": statistics.median(s["whole"]["syncs"] for s in stats),
          "objects_visited_per_incremental_frame": statistics.median(s["incremental"]["objects_visited"] for s in stats),
          "seconds": {"card": t1 - t0, "counted_frame": t1b - t1, "cpu_reference": t2 - t1b}, "launches": frame_launches,
          "issued_per_incremental_frame": counted["incremental"], "issued_per_whole_render": counted["whole"],
          "launches_per_incremental_frame": counted["incremental_launches"],
          "launches_per_whole_render": counted["whole_launches"],
          "equal": {"tolerance": 0, "whole_window": True, "cache_off_frames": N_GENERAL_SCRATCH_FRAMES,
                    "cpu_frames": N_GENERAL_CPU_FRAMES}})

    # One render of each other filter and of the CPG demo, each moved over
    # the lion's middle; the lion's sprites stay cached from demo to demo.
    # The lion is thinned to every DEMO_LION_STRIDE-th path here (the whole
    # lion lies under the lens above): the CPU's renders are this phase's time.
    objs = objs[::DEMO_LION_STRIDE]
    names = ("monofilter", "hole", "rgbfilter", "affinefilter", "wireframe", "smear", "cpg_example", "brush",
             "monobrush")
    placed = [R.position_anchor(R.Centre, (float(W * 3 // 16), float(H // 2)), getattr(examples, name)()) for name in names]
    rendered, demos = {}, {}
    for device in (dev, "cpu"):
        fresh_cache()
        shape = region.shape_of_box(WINDOW, device)
        bare = R.render_simple_scene(objs, shape, device)
        for name, demo in zip(names, placed):
            before = dict(kernels.launches)
            rendered[name, device], st = measured(torch, device, lambda: R.render_simple_scene([demo] + objs, shape, device))
            if device == dev:
                demos[name] = {"host_ms": st["host_ms"], "event_ms": st["event_ms"], "syncs": st["syncs"],
                               "launches": {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}}
    for name in names:
        require(rendered[name, dev] is not None and same_sprite(torch, rendered[name, dev], rendered[name, "cpu"]),
                f"general_filters: {name} differs from the CPU's")
        require(not same_sprite(torch, rendered[name, "cpu"], bare), f"general_filters: {name} changed no pixel of the lion")
    # The smear walks in one smear_walk launch; each brush stamps in one brush_stamp launch (plane mode).
    for name, kernel in (("smear", "smear_walk"), ("brush", "brush_stamp"), ("monobrush", "brush_stamp")):
        require(demos[name]["launches"].get(kernel, 0) >= 1, f"general_filter_demos: {name} launched no {kernel}")
    cache.clear()
    emit({"phase": "general_filter_demos", "lion_paths": len(objs), "demos": demos, "equal": {"tolerance": 0, "cpu": True}})
    frame_launches["counted_frame"] = counted
    return frame_launches, {name: demo["launches"] for name, demo in demos.items()}


def convolve_frame(torch, dev):
    """Config 4's input as benchmarks/run.py makes it: a random
    premultiplied 1088 x 1920 int32 frame (seed 0) on `dev`, and its
    numpy array."""
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (CONV_H, CONV_W, 1))
    rgb = (rng.integers(0, 256, (CONV_H, CONV_W, 3)) * a) // 255
    frame_np = np.concatenate([rgb, a], -1).astype(np.int32)
    return torch.from_numpy(frame_np).to(dev), frame_np


def convolve_1080p(torch, dev, kernels):
    """Config 4 as benchmarks/run.py defines it: a random premultiplied
    1088 x 1920 frame, mkgaussian(5) over the whole frame, 30 chained
    calls, each the launches of convolve_canvas (CV1) that
    kernels.convolve_route gives (one, the staged route) and no other,
    counted from zero; the first call against the CPU's.  Returns the
    launch counts."""
    from coherence_tpu_torch.raster import convolve

    frame, frame_np = convolve_frame(torch, dev)
    kernel = convolve.mkgaussian(BLUR_RADIUS)
    mask = torch.ones((CONV_H, CONV_W), dtype=torch.bool, device=dev)
    zero_counts(torch, kernels)
    first = convolve.convolve_canvas(kernel, frame, mask)
    want = convolve.convolve_canvas(kernel, torch.from_numpy(frame_np), torch.ones((CONV_H, CONV_W), dtype=torch.bool))
    require(torch.equal(first.cpu(), want), "convolve_1080p: the card's blur differs from the CPU's")
    state = {"x": frame}

    def call(_k):
        state["x"] = convolve.convolve_canvas(kernel, state["x"], mask)

    ms, host_s = timed_frames(torch, call, CONV_CALLS)
    counts = dict(kernels.launches)
    route = kernels.convolve_route("xy", CONV_H, CONV_W, kernel.radius)
    require(counts["convolve_canvas"] == route.launches * (CONV_CALLS + 1)
            and sum(counts.values()) == counts["convolve_canvas"],
            f"convolve_1080p: not the {route.launches} convolve_canvas launches of its route a call and nothing else: "
            f"{counts}")
    require(bool(((state["x"] >= 0) & (state["x"] <= 255)).all()), "convolve_1080p: a channel left 0..255")
    # Each input read once, the output written once: the int32 frame twice and the mask.
    nbytes = 2 * frame.numel() * 4 + mask.numel()
    emit({"phase": "convolve_1080p", "shape": [CONV_H, CONV_W], "radius": BLUR_RADIUS, "calls": CONV_CALLS,
          **frame_stats(ms), "host_ms_per_call": host_s / CONV_CALLS * 1e3, "bytes": nbytes,
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "launches": counts["convolve_canvas"],
          "route": {**route._asdict(), "launches": route.launches},
          "equal": {"tolerance": 0, "cpu_first_call": True}})
    return counts


def stroked_tiles(torch, dev, kernels):
    """assets/zoom.pdf (3 paths, 2 of them stroked) scaled to fill the
    frame, through pdfscene and the tile route; and the five icon PDFs
    through the general renderer.  Both against the CPU."""
    import os

    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import examples, fastframe, icons
    from coherence_tpu_torch.scene import render as R

    page = examples.load_text("zoom.pdf")
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(page)
    scale = min((W - 40) / (xmax - xmin), (H - 40) / (ymax - ymin))
    page = R.transform_renderobject_many(
        [tr.Translate(20.0, float(H - 20)), tr.Scale((0.0, 0.0), 1.0, -1.0), tr.Scale((0.0, 0.0), scale, scale),
         tr.Translate(-xmin, -ymin)], page)
    objs = list(page.geometry.objects)
    n_stroked = sum(isinstance(o.geometry.shape, R.StrokedPathShape) for o in objs)
    require(n_stroked == 2 and len(objs) == 3, f"zoom.pdf gave {len(objs)} paths, {n_stroked} stroked")
    zero_counts(torch, kernels)
    shown = {}
    for device in (dev, "cpu"):
        view = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=device)
        view.set_scene(objs, tiled=True)
        view.render(full=True)
        shown[device] = (view.frame.cpu(), view.ts.atlas().cpu(), [list(view.ts.pieces[k]) for k in view.order])
    launches = dict(kernels.launches)
    require(launches["composite_full"] >= 1, "stroked_tiles: composite_full was not launched")
    require(torch.equal(shown[dev][0], shown["cpu"][0]), "stroked_tiles: the card's frame differs from the CPU's")
    require(torch.equal(shown[dev][1], shown["cpu"][1]) and shown[dev][2] == shown["cpu"][2],
            "stroked_tiles: the card's atlas or piece lists differ from the CPU's")
    require(bool((shown[dev][0] != shown[dev][0][0, 0]).any()), "stroked_tiles: nothing was drawn")
    names = ["down", "up", "pointer", "zoom", "brushcurve"]
    t0 = time.perf_counter()
    for name in names:
        fname = os.path.join(examples.path, name + ".pdf")
        fresh_cache()
        on_card = icons.icon_of_pdf(fname, dev)
        fresh_cache()
        on_cpu = icons.icon_of_pdf(fname, "cpu")
        require(tuple(on_card.rgba.shape) == (32, 32, 4) and bool((on_card.rgba[..., 3] > 0).any()),
                f"stroked_tiles: icon {name} is empty")
        require(torch.equal(on_card.rgba.cpu(), on_cpu.rgba), f"stroked_tiles: icon {name} differs from the CPU's")
    fresh_cache()
    emit({"phase": "stroked_tiles", "pdf": "assets/zoom.pdf", "paths": len(objs), "stroked": n_stroked,
          "pieces": sum(len(p) for p in shown[dev][2]), "launches": launches, "icons": names,
          "icons_seconds": time.perf_counter() - t0, "equal": {"tolerance": 0, "cpu_frame": True, "cpu_icons": True}})


# ---------------------------------------------------------------------------
# The sprite route, the scene edits and the device window path: full
# sprites by the batched raster; FrameBuffer's windows and each group
# folded by the fold_layers kernel.
# ---------------------------------------------------------------------------

N_CHURN = 50  # remove and re-add the blob this many times
N_BOXES = 500
N_FRAME_PATH = 20
N_CHECKED_FRAMES = 3  # scene_edits and frame_path frames held against the CPU (frame_path: also the general renderer)


def plain_obj(shape, colour, t=()):
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.raster import fills
    from coherence_tpu_torch.scene import render as R

    return R.Obj(ident.new_ids(), R.Basic(fills.plain(colour), shape), tuple(t), R.OVER)


def lion_edits(objs):
    """The edits of scene_edits on the bench.py lion, as (name, edit of a
    view): a translucent circle added on top over the middle of the lion, a
    lion path recoloured in place, a path removed, and the circle swapped in
    the order with a path under its centre."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.scene import render as R

    bounds = [R.bounds_of_basicshape(o) for o in objs]
    cx = int((min(b[0] for b in bounds) + max(b[1] for b in bounds)) / 2)
    cy = int((min(b[2] for b in bounds) + max(b[3] for b in bounds)) / 2)
    circle = plain_obj(R.PathShape(gshapes.circle(float(cx), float(cy), 120.0)), C.dissolve(C.steelblue, delta=160))
    src = objs[10]
    recoloured = plain_obj(src.geometry.shape, C.dissolve(C.gold, delta=230), src.transform)

    def covers(spr, x: int, y: int) -> bool:
        x0, y0, x1, y1 = spr.box
        return x0 <= x <= x1 and y0 <= y <= y1 and bool(spr.mask[y - y0, x - x0])

    def swap(view):
        order = list(view.order)
        top = order.index(circle.idset)
        j = next(j for j in range(top + 1, len(order))
                 if view.sprites.get(order[j]) is not None and covers(view.sprites[order[j]], cx, cy))
        order[top], order[j] = order[j], order[top]
        view.restack(order)

    return [("add_object", lambda v: v.add_object(circle, 0)),
            ("replace_object", lambda v: v.replace_object(src.idset, recoloured)),
            ("remove_object", lambda v: v.remove_object(objs[20].idset)),
            ("restack", swap)]


def fresh_full(dev, scene):
    """A fresh view of `scene` built by the tile route, rendered whole."""
    from coherence_tpu_torch.scene import fastframe

    view = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=dev)
    view.set_scene(scene, tiled=True)
    view.render(full=True)
    return view


def seeded_boxes(n: int):
    """n boxes of seeded sizes, places and colours in the frame, as
    add_boxes takes them: [(key, (x0, y0, x1, y1), (r, g, b, a))]."""
    import numpy as np

    rng = np.random.default_rng(9)
    items = []
    for k in range(n):
        x0, y0 = int(rng.integers(1, W - 20)), int(rng.integers(1, H - 20))
        w, h = int(rng.integers(4, 160)), int(rng.integers(4, 120))
        a = int(rng.choice([255, 200, 120]))
        rgb = [int(v) * a // 255 for v in rng.integers(0, 256, 3)]
        items.append((("box", k), (x0, y0, min(W, x0 + w - 1), min(H, y0 + h - 1)), (*rgb, a)))
    return items


def fallback_scene(objs):
    """The lion with a gradient-filled circle, a CPG and a group on top:
    objects the tile rasterizer does not take."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import fills
    from coherence_tpu_torch.scene import render as R

    grad = R.Obj(ident.new_ids(), R.Basic(fills.gradient((0.68 * W, 0.28 * H), (0.88 * W, 0.65 * H), True, True, C.red,
                                                         C.dissolve(C.gold, delta=150)),
                                          R.PathShape(gshapes.circle(0.78 * W, 0.46 * H, 0.17 * H))), (), R.OVER)
    cpg = plain_obj(R.CPG(R.SUBTRACTION, R.PathShape(gshapes.circle(0.78 * W, 0.79 * H, 0.14 * H)),
                          R.PathShape(gshapes.circle(0.81 * W, 0.79 * H, 0.08 * H))), C.navy)
    group = R.mkgroup([plain_obj(R.PathShape(gshapes.circle(0.62 * W, 0.83 * H, 0.09 * H)), C.dissolve(C.teal, delta=180)),
                       plain_obj(R.PathShape(gshapes.circle(0.67 * W, 0.80 * H, 0.065 * H)), C.crimson)])
    return [grad, cpg, group] + objs


def scene_edits(torch, dev, kernels):
    """The bench.py lion and blob through the sprite route
    (set_scene(objs)), its full render (composite_full) against the tile
    route's, then the scene edits, each followed by a dirty render
    (composite_dirty) held against a fresh view's full render of the edited
    scene: add_object, replace_object, remove_object, restack, remove and
    re-add of the blob N_CHURN times (the atlas's capacity and piece count
    stay put), add_boxes of N_BOXES boxes against add_object of the same
    boxes as sprites.  The first three frames are also held against the
    CPU.  Last, the tile build of the lion with a gradient circle, a CPG and
    a group (the scalar fallback) against the sprite route.  Returns the
    launch counts, and the lion's sprites on the card and on the CPU (the
    blob first) for fold_kernel and frame_path."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.raster import fills, region
    from coherence_tpu_torch.scene import cache, examples, fastframe

    objs, blob, f_geom = examples.bench_scene(W, H, blob_radius=60, blob_at=(120, 400), f_box=F_BOX)
    scene = [blob] + objs
    edits = lion_edits(objs)
    fresh_cache()
    scene_caches_clear()
    t0 = time.perf_counter()
    cview = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device="cpu")
    cview.set_scene(scene)
    cpu_sprites = [cview.sprites[o.idset] for o in scene]
    cview.render(full=True)
    cpu_frames = [cview.frame.clone()]
    for _, edit in edits[: N_CHECKED_FRAMES - 1]:
        edit(cview)
        cview.render()
        cpu_frames.append(cview.frame.clone())
    cpu_s = time.perf_counter() - t0
    del cview
    fresh_cache()

    zero_counts(torch, kernels)
    t0 = time.perf_counter()
    view = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=dev)
    view.set_scene(scene)
    view.render(full=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sprites = [view.sprites[o.idset] for o in scene]
    require(all(s is not None for s in sprites), "scene_edits: the sprite route kept no sprite of an object")
    tiled = fresh_full(dev, scene)
    require(torch.equal(view.frame, tiled.frame), "scene_edits: the sprite route's full render differs from the tile route's")
    require(torch.equal(view.frame.cpu(), cpu_frames[0]), "scene_edits: the card's sprite route differs from the CPU's")
    checked, ms = [], {}
    for k, (name, edit) in enumerate(edits):
        before = view.frame.clone()
        t0 = time.perf_counter()
        edit(view)
        view.render()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        require(not torch.equal(view.frame, before), f"scene_edits: {name} changed no pixel")
        fresh = fresh_full(dev, [view.objs[key] for key in view.order])
        require(torch.equal(view.frame, fresh.frame), f"scene_edits: after {name} the frame differs from a fresh view's")
        if k + 1 < len(cpu_frames):
            require(torch.equal(view.frame.cpu(), cpu_frames[k + 1]), f"scene_edits: after {name} the card differs from the CPU")
        checked.append(name)
    cap, n_pieces = int(view.ts.atlas().shape[0]), view.ts._n_pieces
    t0 = time.perf_counter()
    for _ in range(N_CHURN):
        view.remove_object(blob.idset)
        view.render()
        view.add_object(blob, 0)
        view.render()
        require((int(view.ts.atlas().shape[0]), view.ts._n_pieces) == (cap, n_pieces),
                "scene_edits: remove and re-add of the blob moved the atlas's capacity or piece count")
    torch.cuda.synchronize()
    ms["churn_cycle"] = (time.perf_counter() - t0) * 1e3 / N_CHURN
    require(torch.equal(view.frame, fresh_full(dev, [view.objs[key] for key in view.order]).frame),
            "scene_edits: after the churn the frame differs from a fresh view's")

    items = seeded_boxes(N_BOXES)
    keys = [key for key, _, _ in items]
    as_sprites = fresh_full(dev, [view.objs[key] for key in view.order])
    t0 = time.perf_counter()
    view.ts.add_boxes(items)
    view.order = keys + view.order
    for key in keys:
        view.dirty |= view._tiles_of(key)
    view.render()
    torch.cuda.synchronize()
    ms["add_boxes"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for key, box, rgba in items:
        col = C.colour_of_rgba(*rgba)
        as_sprites.ts.add_object(key, region.fillshape(region.shape_of_box(box, dev), fills.plain(col)))
    as_sprites.order = keys + as_sprites.order
    as_sprites.render(full=True)
    torch.cuda.synchronize()
    ms["add_object_of_the_boxes"] = (time.perf_counter() - t0) * 1e3
    require(torch.equal(view.frame, as_sprites.frame), "scene_edits: add_boxes differs from add_object of the same boxes")
    dirty_content = view.frame.clone()
    view.render(full=True)
    require(torch.equal(view.frame, dirty_content), "scene_edits: the dirty render after add_boxes differs from a full one")

    mixed = fallback_scene(objs)
    staged = fastframe.stage_tiled_scene(view.ts.nty, view.ts.ntx, W, H, [(o.idset, o) for o in mixed], dev)
    require(staged[5] is None and len(staged[3]) == 3, "scene_edits: the fallback objects were not staged for the scalar route")
    tiled_mixed = fresh_full(dev, mixed)
    sprite_mixed = fastframe.DeviceView(W, H, atlas_cap=ATLAS_CAP, device=dev)
    sprite_mixed.set_scene(mixed)
    sprite_mixed.render(full=True)
    require(torch.equal(tiled_mixed.frame, sprite_mixed.frame), "scene_edits: the tile build's fallback differs from the sprite route")
    require(not torch.equal(tiled_mixed.frame, tiled.frame), "scene_edits: the fallback objects drew nothing")
    counts = dict(kernels.launches)
    require(counts["composite_dirty"] >= len(edits) + 2 * N_CHURN + 1, "scene_edits: the edits did not render through composite_dirty")
    require(counts["composite_full"] >= 1, "scene_edits: composite_full never launched")
    require(counts["fold_layers"] >= 1, "scene_edits: the fallback group did not fold through fold_layers")
    cache.clear()
    emit({"phase": "scene_edits", "size": [W, H], "objects": len(scene), "build_s": build_s,
          "cpu_reference_s": cpu_s, "edit_ms": ms, "churn": N_CHURN, "boxes": N_BOXES,
          "atlas_slots": cap, "pieces": n_pieces, "launches": counts,
          "equal": {"tolerance": 0, "tiled_route": True, "fresh_view_after": checked + ["churn"],
                    "add_boxes_vs_add_object": True, "cpu_frames": len(cpu_frames), "fallback_vs_sprite_route": True}})
    return counts, {"scene": scene, "f_geom": f_geom, "card": sprites, "cpu": cpu_sprites}


def fold_bound(torch, offs, layers, acc, open_mask) -> dict:
    """The bytes fold_layers must move for this run's layers and carry, per
    32-byte sector: each pixel open in the carry reads the mask byte of
    every layer over it until it closes, and 16 bytes of RGBA where that
    mask is set; the carry (acc, open, covered: 18 bytes a pixel) is read
    once and written once; the layer table (32 bytes a layer) read once.
    The pixels close as the plain fold closes them, from the carry's alpha."""
    hb, wb = open_mask.shape
    dev = open_mask.device
    open_mask = open_mask.clone()
    alpha = acc[..., 3].clone()
    mask_sectors = rgba_sectors = 0
    for (dy, dx), (rgba, mask) in zip(offs, layers):
        hs, ws = mask.shape
        y0, y1, x0, x1 = max(0, dy), min(hb, dy + hs), max(0, dx), min(wb, dx + ws)
        if y0 >= y1 or x0 >= x1:
            continue
        rows = torch.arange(y0 - dy, y1 - dy, device=dev)[:, None]
        cols = torch.arange(x0 - dx, x1 - dx, device=dev)[None, :]
        q = rows * ws + cols
        o = open_mask[y0:y1, x0:x1]
        m = mask[y0 - dy : y1 - dy, x0 - dx : x1 - dx] & o
        mask_sectors += int(torch.unique(q[o] // 32).numel())
        rgba_sectors += int(torch.unique(q[m] // 2).numel())
        a = alpha[y0:y1, x0:x1]
        la = rgba[y0 - dy : y1 - dy, x0 - dx : x1 - dx, 3]
        t = la * a + 128
        blended = torch.where(a == 0, la, torch.where(a == 255, a, la + a - (((t >> 8) + t) >> 8)))
        a.copy_(torch.where(m, blended, a))
        open_mask[y0:y1, x0:x1] &= ~(m & (a == 255))
    n_bytes = (mask_sectors + rgba_sectors) * SECTOR_BYTES + 2 * 18 * hb * wb + 32 * len(layers)
    return {"bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "mask_sectors": mask_sectors,
            "rgba_sectors": rgba_sectors, "open_after": int(open_mask.sum())}


def fold_visits(offs, shapes, open_mask, tile) -> dict:
    """A model of the tiled fold's walk, computed on the host from the
    layers' boxes ((hs, ws) each at its (dy, dx)), not counted by the
    kernel: a tile of (th, tw) pixels with no pixel open in the carry lists
    no layer; any other lists every layer whose box meets its part of the
    window.  listed_visits_upper_bound: each of a tile's pixels visits each
    listed layer (a warp stops earlier once its pixels are closed).  Beside
    it the visits of a fold in which every pixel tests every layer
    (all_pairs, K x pixels)."""
    import numpy as np

    th, tw = tile
    hb, wb = open_mask.shape
    nty, ntx = -(-hb // th), -(-wb // tw)
    inside = np.zeros((nty * th, ntx * tw), bool)
    inside[:hb, :wb] = True
    opened = np.zeros_like(inside)
    opened[:hb, :wb] = open_mask.cpu().numpy()
    pixels = inside.reshape(nty, th, ntx, tw).sum((1, 3))
    open_tiles = opened.reshape(nty, th, ntx, tw).any((1, 3))
    lists = np.zeros((nty, ntx), np.int64)
    for (dy, dx), (hs, ws) in zip(offs, shapes):
        y0, y1, x0, x1 = max(0, dy), min(hb, dy + hs), max(0, dx), min(wb, dx + ws)
        if y0 < y1 and x0 < x1:
            lists[y0 // th : (y1 - 1) // th + 1, x0 // tw : (x1 - 1) // tw + 1] += 1
    lists *= open_tiles
    return {"tile": [th, tw], "tiles": nty * ntx, "open_tiles": int(open_tiles.sum()),
            "tile_list_entries": int(lists.sum()), "deepest_list": int(lists.max()),
            "listed_visits_upper_bound": int((lists * pixels).sum()), "all_pairs": len(offs) * hb * wb}


@contextlib.contextmanager
def recorded_folds():
    """Inside, every fold_layers_carry call (framepath's, and the name
    fastframe imported) appends its arguments (offs, layers, acc,
    open_mask, covered) to the yielded list, then runs as before."""
    from coherence_tpu_torch.raster import framepath
    from coherence_tpu_torch.scene import fastframe

    calls, real = [], framepath.fold_layers_carry

    def recording(offs, layers, acc, open_mask, covered):
        calls.append(([tuple(int(v) for v in o) for o in offs], list(layers), acc, open_mask, covered))
        return real(offs, layers, acc, open_mask, covered)

    framepath.fold_layers_carry = fastframe.fold_layers_carry = recording
    try:
        yield calls
    finally:
        framepath.fold_layers_carry = fastframe.fold_layers_carry = real


def fold_host_ms(torch, call) -> dict:
    """The host's side of a fold, `call()`: the wrapper's checks, packing,
    upload and launch, queued and not waited for; milliseconds per call of
    N_TIMED calls, the median (host_ms) and the most (host_ms_max)."""
    host = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"host_ms": statistics.median(host), "host_ms_max": max(host)}


def fold_shape(torch, dev, scrub, fold) -> dict:
    """One fold of fold_kernel: fold_layers against fold_layers_carry_torch
    on `fold` = (offs, layers, acc, open_mask, covered), moved to `dev`, in
    one call and in two with the carry (the first half of the layers, then
    the rest); bit for bit, carry and all; fold_host_ms; then the two timed
    in turns behind a device-side wait of 4 x host_ms_max (wait_ms), a timed
    call of the kernel that outlasts half of it on the host timed again
    (retaken)."""
    from coherence_tpu_torch.raster import framepath as FP

    offs, layers, *carry = fold
    layers = [(r.to(dev).contiguous(), m.to(dev).contiguous()) for r, m in layers]
    carry = [t.to(dev).contiguous() for t in carry]
    cut = len(layers) // 2
    got = FP.fold_layers_carry(offs, layers, *carry)
    want = FP.fold_layers_carry_torch(offs, layers, *carry)
    first = FP.fold_layers_carry(offs[:cut], layers[:cut], *carry)
    chunked = FP.fold_layers_carry(offs[cut:], layers[cut:], *first)
    torch.cuda.synchronize()
    for name, g, w, c in zip(("acc", "open", "covered"), got, want, chunked):
        require(torch.equal(g, w), f"fold_layers differs from fold_layers_carry_torch in {name}")
        require(torch.equal(c, w), f"fold_layers in two calls with the carry differs in {name}")
    require(bool((want[2] & ~carry[2]).any()) and not torch.equal(want[1], carry[1]),
            "fold_kernel: the fold covered or closed nothing")
    row = {"max_abs_err": max_abs_err(got[0], want[0]), "layers": len(layers), "window": list(carry[1].shape),
           "open_before": int(carry[1].sum()), "chunk": cut, **fold_bound(torch, offs, layers, carry[0], carry[1])}
    row.update(fold_host_ms(torch, lambda: FP.fold_layers_carry(offs, layers, *carry)))
    row["wait_ms"] = 4 * row["host_ms_max"]
    retaken = RETAKEN[0]
    row.update(in_turns(torch, lambda: FP.fold_layers_carry(offs, layers, *carry), scrub, wait_ms=row["wait_ms"],
                        plain=lambda: FP.fold_layers_carry_torch(offs, layers, *carry)))
    row["share"] = row["bound_ms"] / row["ms"]
    row["retaken"] = RETAKEN[0] - retaken
    return row


def fold_shapes(torch, dev, sprites, group_fold, blur_fold) -> dict:
    """The three folds the program gives fold_layers, by name, as
    (offs, layers, acc, open_mask, covered): the lion's 132 sprites (the
    sprite route's, from full_sprites_of_objects) over the whole 1920x1080
    window, every pixel open; the lion group's fold as general_lion's render
    called it, the update shape's mask open; the last recomposite_blur
    window of frame_path, its prefiltered layer pack and inwin open."""
    lion = sprites[1:]
    window = ([(s.box[1] - 1, s.box[0] - 1) for s in lion], [(s.rgba, s.mask) for s in lion],
              torch.zeros((H, W, 4), dtype=torch.int32, device=dev), torch.ones((H, W), dtype=torch.bool, device=dev),
              torch.zeros((H, W), dtype=torch.bool, device=dev))
    return {"lion_window": window, "lion_group": group_fold, "blur_window": blur_fold}


def fold_kernel(torch, dev, scrub, kernels, folds):
    """fold_layers at each of fold_shapes' folds (fold_shape each), with
    fold_visits' model of each fold's tile lists at the kernel's tile in the
    phase's line.  Returns the kernels line's row: the whole-window fold's
    numbers, each shape's beside them."""
    shapes = {name: fold_shape(torch, dev, scrub, fold) for name, fold in folds.items()}
    visits = {name: fold_visits(offs, [m.shape for _, m in layers], open_mask, kernels.fold_tile())
              for name, (offs, layers, _, open_mask, _) in folds.items()}
    emit({"phase": "fold_kernel", "tolerance": 0, "equal_plain": True, "equal_chunked": True,
          "shapes": {name: {**row, "host_model": visits[name]} for name, row in shapes.items()}})
    return {**shapes["lion_window"], "shapes": shapes}


def frame_path(torch, dev, kernels, lion):
    """A FrameBuffer at 1920x1080 composites the lion's sprites (the blob
    on top, an opaque white backdrop under the lion), applies the radius-5
    blur over F_BOX, then recomposites N_FRAME_PATH frames of the blob
    dragged under the lens (recomposite_blur, each window one fold_layers
    launch).  Frames 0-2 are held against the same frames on the CPU and
    against the general renderer's render of the same filtered scene; the
    last against a whole-window recomposite plus apply_blur.  Returns the
    launch counts, and the last blur window's fold in the CPU's frames
    (its arguments, for fold_kernel)."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.raster import convolve, fills, framepath, region
    from coherence_tpu_torch.scene import cache, fastframe, filters
    from coherence_tpu_torch.scene import render as R

    f_geom, (blob, *objs) = lion["f_geom"], lion["scene"]
    kernel = convolve.mkgaussian(BLUR_RADIUS)
    backdrop = plain_obj(R.rectangle(1.0, 1.0, float(W), float(H)), C.white)

    def layer_stack(device, sprs):
        return list(sprs) + [fastframe.full_sprite_of_object(backdrop, device)]

    def run(device, stack, n, timed):
        alpha = fastframe.alpha_plane_of_object(f_geom, W, H, device)
        fb = framepath.FrameBuffer(W, H, C.white, device=device)
        fb.composite(WINDOW, stack)
        fb.apply_blur(alpha, kernel)
        shown, state = [fb.rgba.clone()], {"blob": stack[0]}

        def frame(k):
            spr = state["blob"]
            moved = region.translate_sprite(*delta(k * 20), spr)
            fb.recomposite_blur(region.box_union(spr.box, moved.box), [moved] + stack[1:], alpha, kernel)
            state["blob"] = moved
            if k + 1 < N_CHECKED_FRAMES:
                shown.append(fb.rgba.clone())

        if timed:
            ms, _ = timed_frames(torch, frame, n)
        else:
            ms = [frame(k) for k in range(n)]
        return fb, shown, state["blob"], alpha, ms

    fresh_cache()
    with recorded_folds() as folds:
        _, cpu_shown, _, _, _ = run("cpu", layer_stack("cpu", lion["cpu"]), N_CHECKED_FRAMES - 1, False)
    require(len(folds) == N_CHECKED_FRAMES and folds[-1][3].numel() < H * W,
            "frame_path: the CPU's frames did not fold the whole window, then one blur window each")
    fresh_cache()  # the backdrop's and the lens's shapes are cached per device (H23)
    zero_counts(torch, kernels)
    stack = layer_stack(dev, lion["card"])
    fb, shown, last_blob, alpha, ms = run(dev, stack, N_FRAME_PATH, True)
    counts = dict(kernels.launches)
    require(counts["fold_layers"] == N_FRAME_PATH + 1, f"frame_path: fold_layers launched {counts['fold_layers']} times")
    # apply_blur's rect blend, then one window blend a frame.
    require(counts["blur_blend"] == N_FRAME_PATH + 1, f"frame_path: blur_blend launched {counts['blur_blend']} times")
    for k, (a, b) in enumerate(zip(shown, cpu_shown)):
        require(torch.equal(a.cpu(), b), f"frame_path: frame {k} differs from the CPU's")
    whole = framepath.FrameBuffer(W, H, C.white, device=dev)
    whole.recomposite(WINDOW, [last_blob] + stack[1:])
    whole.apply_blur(alpha, kernel)
    require(torch.equal(whole.rgba, fb.rgba), "frame_path: the last frame differs from a whole-window recomposite and blur")

    # The general renderer's frames of the same filtered scene, over white.
    fresh_cache()
    lens = R.Obj(ident.new_ids(), filters.blur(f_geom.geometry, kernel), (), R.OVER)
    master = region.shape_of_box(WINDOW, dev)
    white = region.fillshape(master, fills.plain(C.white))
    t0 = time.perf_counter()
    for k in range(N_CHECKED_FRAMES):
        spr = R.render_simple_scene([lens, blob] + objs + [backdrop], master, dev)
        out, _ = region.caf("over", "opaque", spr, white)
        require(out.box == WINDOW and torch.equal(out.rgba, shown[k]),
                f"frame_path: frame {k} differs from the general renderer's render of the scene")
        blob = R.translate_renderobject(*delta(k * 20), blob)
    general_s = time.perf_counter() - t0
    cache.clear()
    emit({"phase": "frame_path", "size": [W, H], "layers": len(stack), "frames": N_FRAME_PATH,
          "blur_radius": BLUR_RADIUS, **frame_stats(ms), "general_renderer_s": general_s, "launches": counts,
          "equal": {"tolerance": 0, "cpu_frames": N_CHECKED_FRAMES, "general_renderer_frames": N_CHECKED_FRAMES,
                    "last_frame_whole_window": True}})
    return counts, folds[-1]


# The serving surface (benchmarks/session.py): both sessions at W x H.
SERVE_BLUR = 3
SERVE_WARM = 8
SERVE_FAST_DRAGS = 100
# session.py drags 100 times through the Engine too; 40 here, since an
# incremental frame of the general renderer takes tens of ms on this path
# and the script's time is limited.  The warm-up and the other stages are whole.
SERVE_ENGINE_DRAGS = 40
SERVE_FLOOR_PAINTS = 11
SERVE_BLUR_STEPS = [1, 2, 3, 4, 5, 6, 5, 4, 3, 2]
SERVE_CPU_FAST_DRAGS = 10
SERVE_CPU_ENGINE_DRAGS = 3
SERVE_DEADLINE_S = 300.0  # no wait on a socket outlasts this


def serve_blob(w: int, h: int):
    return int(w * 0.22), int(h * 0.25), max(24, h // 18)


def serve_drag(k: int):
    return (5, 3) if (k // 40) % 2 == 0 else (-5, -3)


def serve_lion(w: int, h: int):
    """The lion scaled to 0.9 of the window's height, as one Group."""
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import examples
    from coherence_tpu_torch.scene import render as R

    lion = examples.smalllion()
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(lion)
    scale = (h * 0.9) / max(xmax - xmin, ymax - ymin)
    return R.transform_renderobject_many(
        [tr.Translate(w * 0.05, h * 0.95), tr.Scale((0.0, 0.0), 1.0, -1.0), tr.Scale((0.0, 0.0), scale, scale),
         tr.Translate(-xmin, -ymin)], lion)


def fast_scene(w: int, h: int):
    """session.py's fast_scene: the lion's paths, the draggable blob, the
    lens rectangle."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import fills as rfills
    from coherence_tpu_torch.scene import render as R

    bx, by, br = serve_blob(w, h)
    blob = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.dissolve(C.red, delta=160)),
                                          R.PathShape(gshapes.circle(0.0, 0.0, float(br)))),
                 (tr.Translate(float(bx), float(by)),), R.OVER)
    f_geom = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.white), R.rectangle(w * 0.30, h * 0.45, w * 0.40, h * 0.25)),
                   (), R.OVER)
    return list(serve_lion(w, h).geometry.objects), blob, f_geom


def engine_scene(w: int, h: int):
    """session.py's build_scene: the blob over a blur filter band over the
    lion."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import convolve, fills as rfills
    from coherence_tpu_torch.scene import filters
    from coherence_tpu_torch.scene import render as R

    bx, by, br = serve_blob(w, h)
    filt = R.Obj(ident.new_ids(), filters.blur(R.Basic(rfills.plain(C.white),
                                                       R.rectangle(w * 0.30, h * 0.45, w * 0.40, h * 0.25)),
                                               convolve.mkgaussian(SERVE_BLUR)), (), R.OVER)
    blob = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.dissolve(C.red, delta=160)),
                                          R.PathShape(gshapes.circle(float(bx), float(by), float(br)))), (), R.OVER)
    return [blob, filt, serve_lion(w, h)]


class Served:
    """A server function in a thread and the port's HeadlessClient in the
    caller's, joined by a localhost TCP socket.  The server function gets
    (connection, ready): it leaves its session in `ready`.  If it raises,
    its socket is closed, so the client's next wait fails instead of
    hanging; a watchdog shuts both sockets at the deadline."""

    def __init__(self, server_fn):
        from coherence_tpu_torch.gui import client, talk

        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        listener.settimeout(SERVE_DEADLINE_S)
        conn = talk.connect(listener.getsockname()[1])
        server_sock, _ = listener.accept()
        listener.close()
        self.ready, self.fail = {}, []
        outer = self

        class _Client(client.HeadlessClient):
            def _on_refresh(self, w):
                outer.refreshes += 1
                outer.last_refresh = time.perf_counter()

        self.refreshes, self.last_refresh = 0, 0.0
        self.c = _Client(conn)
        self._socks = [server_sock, conn.sock]
        self._watchdog = threading.Timer(SERVE_DEADLINE_S, self._cut)
        self._watchdog.daemon = True
        self._watchdog.start()

        def body():
            sconn = talk.Connection(server_sock)
            try:
                server_fn(sconn, self.ready)
            except BaseException as e:  # noqa: BLE001 — raised again by the client's thread
                self.fail.append(e)
            finally:
                sconn.close()

        self.thread = threading.Thread(target=body, daemon=True)
        self.thread.start()

    def _cut(self):
        for s in self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def check(self):
        if self.fail:
            raise self.fail[0]

    def await_refresh(self, n: int = 1) -> float:
        """Serve the server's calls until n more RefreshWindow frames have
        landed in the window image; the arrival time of the last."""
        target = self.refreshes + n
        try:
            while self.refreshes < target:
                if not self.c.handle_one():
                    raise RuntimeError("chip_smoke: the server closed the session early")
        except (ConnectionError, OSError, RuntimeError):
            self.thread.join(10)
            self.check()
            raise
        return self.last_refresh

    def drain(self):
        self.c.pump()

    def barrier(self, win):
        """A 2x2 paint (a 1-wide rect is never shipped): when it lands,
        every earlier event has been handled."""
        self.c.paint(win, 0, 0, 2, 2)
        self.await_refresh()
        self.drain()

    def timed(self, send) -> float:
        """Seconds from an event sent to its pixels landed."""
        t0 = time.perf_counter()
        send()
        t1 = self.await_refresh()
        self.drain()
        return t1 - t0

    def close(self):
        """AppClose, serve until the server has said so too, join it."""
        try:
            self.c.send_event("AppClose")
            while self.c.running and self.c.handle_one():
                pass
        except (ConnectionError, OSError):
            pass
        self.thread.join(SERVE_DEADLINE_S)
        self._watchdog.cancel()
        self.c.conn.close()
        self.check()
        require(not self.thread.is_alive(), "the server thread did not end")


def latency(seconds):
    xs = sorted(seconds)
    return {"median_ms": xs[len(xs) // 2] * 1e3, "p95_ms": xs[min(len(xs) - 1, int(len(xs) * 0.95))] * 1e3}


def fast_session(torch, device, kernels, n_drags: int, whole: bool):
    """One FastSession on `device` and its client.  n_drags drags (the first
    SERVE_WARM untimed when whole); when whole also the wire-floor paints
    and the slider sweep, with the client's image held to the server's
    display plane after the drags and after the slider.  Returns the
    client's image after SERVE_CPU_FAST_DRAGS drags and what was measured."""
    from coherence_tpu_torch.gui import fastserver
    from coherence_tpu_torch.raster import region

    objs, blob, f_geom = fast_scene(W, H)

    def server(conn, ready):
        sess = fastserver.FastSession(conn, W, H, objs, blob, f_geom, blur_radius=SERVE_BLUR, device=device)
        ready["sess"] = sess
        sess.run()

    t_start = time.perf_counter()
    sv = Served(server)
    c = sv.c
    c.app_start()  # FastSession waits for this handshake
    first_paint_s = sv.await_refresh() - t_start
    sv.drain()
    win = next(iter(c.windows))
    while "sess" not in sv.ready:  # the constructor returns once its first frame has landed
        sv.check()
        time.sleep(0.001)
    sess = sv.ready["sess"]
    shipped = []
    real_refresh = sess.wx.display.refresh_window

    def counting_refresh(w, x, y, width, height, data):
        shipped.append(len(data))
        real_refresh(w, x, y, width, height, data)

    sess.wx.display.refresh_window = counting_refresh

    def same_as_server(when):
        plane = sess.disp.rgba[..., :3].to(torch.uint8).cpu().numpy()
        require(bool((c.windows[win].image[:H, :W] == plane).all()),
                f"serve_fast: the client's image differs from the server's display plane {when}")

    same_as_server("after the first paint")
    bx, by, _ = serve_blob(W, H)
    c.mouse = (bx, by)
    c.send_event("LeftDown", win, bx, by)
    x, y = bx, by
    drag_s, at_check = [], None
    timed_from = SERVE_WARM if whole else 0
    for k in range(n_drags):
        if k == timed_from:
            syncs0, launches0, refreshes0, shipped0 = region.syncs, dict(kernels.launches), sv.refreshes, len(shipped)
        dx, dy = serve_drag(k)
        x, y = x + dx, y + dy

        def send():
            c.mouse = (x, y)
            c.send_event("LeftDragging", win, x, y)

        dt = sv.timed(send)
        if k >= timed_from:
            drag_s.append(dt)
        if k + 1 == SERVE_CPU_FAST_DRAGS:
            at_check = c.windows[win].image[:H, :W].copy()
            same_as_server(f"after {k + 1} drags")
    n_timed = n_drags - timed_from
    per_drag = {
        "refreshes": (sv.refreshes - refreshes0) / n_timed,
        "composite_dirty": (kernels.launches["composite_dirty"] - launches0["composite_dirty"]) / n_timed,
        "syncs": (region.syncs - syncs0) / n_timed,
        "bytes": sum(shipped[shipped0:]) / n_timed,
    }
    c.send_event("LeftUp", win, x, y)
    same_as_server("after the drags")
    out = {"first_paint_s": first_paint_s, "drag": latency(drag_s), "per_drag": per_drag, "drags_timed": n_timed}
    if whole:
        out["wire_floor_ms"] = latency([sv.timed(lambda: c.paint(win, 0, 0, 2, 2)) for _ in range(SERVE_FLOOR_PAINTS)])["median_ms"]
        out["slider"] = latency([sv.timed(lambda v=v: c.send_event("BlurSlider", win, v)) for v in SERVE_BLUR_STEPS])
        same_as_server("after the slider")
        out["lens_box"] = list(sess.lens_box)
    sv.close()
    return at_check, out, sess


def serve_fast(torch, dev, kernels):
    """FastSession at 1920x1080 over TCP, counted from zero: returns the
    session's launch counts, and composite_full's launches in the closing
    full-frame render of the session's view (the session itself makes none)."""
    from coherence_tpu_torch.scene import cache, fastframe

    cache.clear()
    scene_caches_clear()
    cpu_image, cpu_stats, _ = fast_session(torch, "cpu", kernels, SERVE_CPU_FAST_DRAGS, whole=False)
    # The scene-build cache's digest names no device: cleared, so that the card rasterizes the scene itself.
    cache.clear()
    scene_caches_clear()
    builds0 = fastframe.scene_build_cache_stats()
    zero_counts(torch, kernels)
    n_drags = SERVE_WARM + SERVE_FAST_DRAGS
    image, stats, sess = fast_session(torch, dev, kernels, n_drags, whole=True)
    require(bool((image == cpu_image).all()),
            f"serve_fast: after {SERVE_CPU_FAST_DRAGS} drags the client's image differs from the CPU session's")
    require(stats["per_drag"]["refreshes"] == 1.0, f"serve_fast: {stats['per_drag']['refreshes']} RefreshWindow frames per drag")
    require(stats["per_drag"]["composite_dirty"] == 1.0,
            f"serve_fast: {stats['per_drag']['composite_dirty']} composite_dirty launches per drag")
    session_counts = dict(kernels.launches)
    builds = fastframe.scene_build_cache_stats()
    require(builds["hits"] == builds0["hits"] and builds["misses"] > builds0["misses"],
            "serve_fast: the card's session took its atlas from the scene-build cache")
    # The first frame, each drag and each slider step composite through the dirty kernel, as in the JAX package.
    require(session_counts["composite_dirty"] == 1 + n_drags + len(SERVE_BLUR_STEPS),
            f"serve_fast: composite_dirty launched {session_counts['composite_dirty']} times")
    require(session_counts["composite_full"] == 0, "serve_fast: the session launched composite_full")
    require(session_counts["shatter_into"] >= n_drags and session_counts["blur_blend"] >= n_drags,
            f"serve_fast: the drags did not reach shatter_into and blur_blend: {session_counts}")
    # The session's content against one full-frame render of its view.
    view = sess.view
    dirty_content = view.frame.clone()
    view.render(full=True)
    torch.cuda.synchronize()
    require(torch.equal(view.frame, dirty_content), "serve_fast: render(full=True) differs from the session's content")
    check_full = kernels.launches["composite_full"] - session_counts["composite_full"]
    require(check_full == 1, f"serve_fast: the closing render launched composite_full {check_full} times")
    cache.clear()
    scene_caches_clear()
    emit({"phase": "serve_fast", "size": [W, H], "blur_radius": SERVE_BLUR, "drags": n_drags, **stats,
          "cpu_first_paint_s": cpu_stats["first_paint_s"], "launches": session_counts,
          "full_render_check_launches": check_full,
          "equal": {"tolerance": 0, "server_plane": True, "cpu_session_after_drags": SERVE_CPU_FAST_DRAGS,
                    "full_render_equal_content": True}})
    return session_counts, check_full


def engine_session(torch, device, n_drags: int, whole: bool):
    """One Engine on `device` behind a RemoteDisplay and its client: first
    paint, a click that picks the blob, n_drags drags; when whole also the
    slider over the selection and the zoom in and out, with the client's
    image held to the engine's framebuffer after every stage.  Returns the
    client's images after the first paint, the pick and each of the first
    SERVE_CPU_ENGINE_DRAGS drags, and what was measured."""
    from coherence_tpu_torch.gui import app
    from coherence_tpu_torch.gui.window import RemoteDisplay
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import profiling

    def server(conn, ready):
        eng = app.Engine(display=RemoteDisplay(conn), device=device)
        view = R.View(device=eng.device, scene=engine_scene(W, H), pages=[], background=[app.background_obj()],
                      master_update=region.shape_of_box((0, 0, W, H), eng.device))
        eng.views.append(view)
        view.window = eng.wx.make_window("session", W, H, 0, 0, 0, 0)
        ready["eng"], ready["view"] = eng, view
        eng.force_update_whole(view)
        eng.run(resilient=False)

    t_start = time.perf_counter()
    sv = Served(server)
    c = sv.c
    first_paint_s = sv.await_refresh() - t_start
    sv.drain()
    win = next(iter(c.windows))
    eng = sv.ready["eng"]
    images = []

    def stage(name, keep=False):
        """The server is idle (a barrier or an awaited frame came back)."""
        sv.check()
        img = c.windows[win].image[:H, :W]
        require(bool((img == eng.wx.framebuffers[win][:H, :W]).all()),
                f"serve_engine: the client's image differs from the engine's framebuffer after {name}")
        if keep:
            images.append(img.copy())

    stage("the first paint", keep=True)
    bx, by, _ = serve_blob(W, H)
    c.mouse = (bx, by)
    c.send_event("LeftDown", win, bx, by)
    sv.barrier(win)  # a first click repaints nothing of its own
    require(len(sv.ready["view"].selections[1][0]) == 1, "serve_engine: the click picked no object")
    stage("the pick", keep=True)
    x, y = bx, by
    drag_s = []
    timed_from = SERVE_WARM if whole else 0
    for k in range(n_drags):
        if k == timed_from:
            syncs0, visited0 = region.syncs, profiling.counters["render.objects_visited"]
        dx, dy = serve_drag(k)
        x, y = x + dx, y + dy

        def send():
            c.mouse = (x, y)
            c.send_event("LeftDragging", win, x, y)

        dt = sv.timed(send)
        if k >= timed_from:
            drag_s.append(dt)
        if k < SERVE_CPU_ENGINE_DRAGS:
            stage(f"drag {k + 1}", keep=True)
    n_timed = n_drags - timed_from
    out = {"first_paint_s": first_paint_s, "drag": latency(drag_s), "drags_timed": n_timed,
           "per_drag": {"syncs": (region.syncs - syncs0) / n_timed,
                        "objects_visited": (profiling.counters["render.objects_visited"] - visited0) / n_timed}}
    c.send_event("LeftUp", win, x, y)
    sv.barrier(win)
    stage("the drags")
    if whole:
        out["wire_floor_ms"] = latency([sv.timed(lambda: c.paint(win, 0, 0, 2, 2)) for _ in range(SERVE_FLOOR_PAINTS)])["median_ms"]
        out["slider"] = latency([sv.timed(lambda v=v: c.send_event("BlurSlider", win, v)) for v in SERVE_BLUR_STEPS])
        c.send_event("BlurSlider", win, 0)
        sv.await_refresh()
        sv.barrier(win)
        stage("the slider")
        c.send_event("Button", 2, win)  # wire order: (button, window)
        sv.barrier(win)
        zx0, zy0, zx1, zy1 = int(W * 0.3), int(H * 0.3), int(W * 0.7), int(H * 0.7)
        c.mouse = (zx0, zy0)
        c.send_event("LeftDown", win, zx0, zy0)
        sv.barrier(win)  # the 1-pixel rubberband seed is never shipped
        for f in (0.4, 0.55, 0.7):
            c.mouse = (int(W * f), int(H * f))
            c.send_event("LeftDragging", win, *c.mouse)
            sv.await_refresh()
        sv.drain()

        def release():
            c.mouse = (zx1, zy1)
            c.send_event("LeftUp", win, zx1, zy1)

        out["zoom_in_s"] = sv.timed(release)
        sv.barrier(win)
        stage("the zoom in")

        def right_click():
            c.mouse = (W // 2, H // 2)
            c.send_event("RightDown", win, W // 2, H // 2)
            c.send_event("RightUp", win, W // 2, H // 2)

        out["zoom_out_s"] = sv.timed(right_click)
        sv.barrier(win)
        stage("the zoom out")
        out["event_errors"] = profiling.counters["engine.event_errors"]
    sv.close()
    return images, out


def serve_engine(torch, dev, kernels):
    """The Engine at 1920x1080 over TCP, against an Engine on the CPU.
    Returns the launch counts: fold_layers alone (the lion group's fold)."""
    from coherence_tpu_torch.scene import cache

    cache.clear()
    cpu_images, cpu_stats = engine_session(torch, "cpu", SERVE_CPU_ENGINE_DRAGS, whole=False)
    cache.clear()
    zero_counts(torch, kernels)
    torch.cuda.reset_peak_memory_stats()
    images, stats = engine_session(torch, dev, SERVE_WARM + SERVE_ENGINE_DRAGS, whole=True)
    require(len(images) == len(cpu_images) == 2 + SERVE_CPU_ENGINE_DRAGS, "serve_engine: stages missing")
    for name, a, b in zip(["the first paint", "the pick"] + [f"drag {k + 1}" for k in range(SERVE_CPU_ENGINE_DRAGS)],
                          images, cpu_images):
        require(bool((a == b).all()), f"serve_engine: after {name} the client's image differs from the CPU engine's client's")
    require(not (images[1] == images[2]).all(), "serve_engine: the first drag changed no pixel")
    require(stats["event_errors"] == 0, "serve_engine: a handler's error was contained")
    counts = dict(kernels.launches)
    tile_counts = {k: n for k, n in counts.items() if k not in GENERAL_KERNELS}
    require(not any(tile_counts.values()), f"serve_engine: the general renderer launched a tile kernel: {counts}")
    require(counts["fold_layers"] >= 1, "serve_engine: the lion group did not fold through fold_layers")
    cache.clear()
    emit({"phase": "serve_engine", "size": [W, H], "blur_radius": SERVE_BLUR, "drags": SERVE_WARM + SERVE_ENGINE_DRAGS,
          **stats, "launches": counts, "cpu_first_paint_s": cpu_stats["first_paint_s"], "cpu_drag_ms_median": cpu_stats["drag"]["median_ms"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "equal": {"tolerance": 0, "engine_framebuffer_after_every_stage": True,
                    "cpu_engine_stages": 2 + SERVE_CPU_ENGINE_DRAGS}})
    return counts


# --- PDF pages: graphics and images through Engine.openfile --------------------

PDF_IMAGE = (1024, 768)  # the Flate RGB image's samples on page 2
PDF_CANVAS = (1280, 1024)  # the Engine's framebuffer (the reference's fixed canvas)


def _cell(i: int):
    """Bottom-left corner of the i-th 130x130 cell of page 1, in the
    1920x1080 design space: 8 cells a row from the top left."""
    return 20 + 140 * (i % 8), 930 - 140 * (i // 8)


def _circle(cx: float, cy: float, r: float) -> bytes:
    k = 0.5523 * r
    return (f"{cx + r} {cy} m {cx + r} {cy + k} {cx + k} {cy + r} {cx} {cy + r} c "
            f"{cx - k} {cy + r} {cx - r} {cy + k} {cx - r} {cy} c {cx - r} {cy - k} {cx - k} {cy - r} {cx} {cy - r} c "
            f"{cx + k} {cy - r} {cx + r} {cy - k} {cx + r} {cy} c h").encode()


def _mesh_bits(fields) -> bytes:
    acc, n = 0, 0
    for v, bits in fields:
        acc = (acc << bits) | (int(v) & ((1 << bits) - 1))
        n += bits
    pad = (-n) % 8
    return (acc << pad).to_bytes((n + pad) // 8, "big")


def _mesh_xy(x: float, y: float):
    return [(round(x / 1920 * 65535), 16), (round(y / 1080 * 65535), 16)]


def _mesh_rgb(r: float, g: float, b: float):
    return [(round(r * 255), 8), (round(g * 255), 8), (round(b * 255), 8)]


# --- page 3's font programs, written here so that nothing is downloaded ------
#
# Each is a few glyphs in a 1000-unit em: a TrueType program with quadratic
# contours, a bare CFF program (Type 2 charstrings) and a Type 1 program
# (eexec-encrypted Type 1 charstrings).

# TrueType glyphs (gid 1-4; 5 is the space): contours of (x, y, on-curve).
TT_GLYPHS = [
    [[(500, 0, 1), (900, 0, 0), (900, 400, 1), (900, 800, 0), (500, 800, 1), (100, 800, 0), (100, 400, 1),
      (100, 0, 0)],
     [(500, 200, 1), (300, 200, 0), (300, 400, 1), (300, 600, 0), (500, 600, 1), (700, 600, 0), (700, 400, 1),
      (700, 200, 0)]],
    [[(100, 0, 1), (500, -120, 0), (900, 0, 1), (500, 800, 1)]],
    [[(100, 0, 1), (300, 0, 1), (300, 650, 1), (200, 820, 0), (100, 650, 1)]],
    [[(450, 0, 1), (800, 50, 0), (800, 400, 1), (450, 800, 1), (100, 400, 1), (100, 50, 0)]],
]
TT_ADVANCES = [500, 1000, 1000, 400, 900, 300]  # .notdef, A, B, C, D, space


def truetype_program() -> bytes:
    """A TrueType font (head, hhea, maxp, loca, glyf, cmap, hmtx): codes A-D
    show gids 1-4, the space gid 5."""
    import struct

    glyphs = [[]] + TT_GLYPHS + [[]]
    glyf, loca = b"", [0]
    for contours in glyphs:
        g = b""
        if contours:
            pts = [p for c in contours for p in c]
            xs, ys = [p[0] for p in pts], [p[1] for p in pts]
            ends, n = [], 0
            for c in contours:
                n += len(c)
                ends.append(n - 1)
            g = struct.pack(">hhhhh", len(contours), min(xs), min(ys), max(xs), max(ys))
            g += struct.pack(f">{len(ends)}H", *ends) + struct.pack(">H", 0)
            g += bytes(p[2] for p in pts)  # flags: on-curve bit, 16-bit deltas
            for coords in (xs, ys):
                g += struct.pack(f">{len(coords)}h", *(v - u for v, u in zip(coords, [0] + coords[:-1])))
            g += b"\0" * (-len(g) % 4)
        glyf += g
        loca.append(len(glyf))
    n = len(glyphs)
    first, codes = 0x20, {0x20: 5, 0x41: 1, 0x42: 2, 0x43: 3, 0x44: 4}
    ids = [codes.get(c, 0) for c in range(first, 0x45)]
    sub = struct.pack(">HHHHH", 6, 10 + 2 * len(ids), 0, first, len(ids)) + struct.pack(f">{len(ids)}H", *ids)
    tables = {
        b"cmap": struct.pack(">HHHHI", 0, 1, 3, 1, 12) + sub,
        b"glyf": glyf,
        b"head": struct.pack(">IIIIHHqqhhhhHHhhh", 0x10000, 0x10000, 0, 0x5F0F3CF5, 0, 1000, 0, 0,
                             100, -120, 900, 820, 0, 8, 2, 1, 0),
        b"hhea": struct.pack(">IhhhHhhhhhhhhhhhH", 0x10000, 800, -200, 0, max(TT_ADVANCES), 0, 0, 900, 1, 0, 0,
                             0, 0, 0, 0, 0, n),
        b"hmtx": b"".join(struct.pack(">Hh", a, 0) for a in TT_ADVANCES),
        b"loca": struct.pack(f">{len(loca)}I", *loca),
        b"maxp": struct.pack(">IH", 0x00005000, n),
    }
    out = struct.pack(">IHHHH", 0x10000, len(tables), 0, 0, 0)
    offset = len(out) + 16 * len(tables)
    body = b""
    for tag, data in tables.items():
        out += struct.pack(">4sIII", tag, 0, offset + len(body), len(data))
        body += data + b"\0" * (-len(data) % 4)
    return out + body


def _t2_num(v: int) -> bytes:
    """A Type 2 charstring operand."""
    import struct

    return bytes([v + 139]) if -107 <= v <= 107 else b"\x1c" + struct.pack(">h", v)


def cff_program() -> bytes:
    """A bare CFF font (FontFile3 /Type1C) in the ISOAdobe charset: gid 1
    is the space, gids 2-4 (exclam, quotedbl, numbersign) a square, a
    curved triangle and a cross."""
    import struct

    def cs(width, *ops):
        out = _t2_num(width)
        for args, op in ops:
            out += b"".join(_t2_num(a) for a in args) + bytes([op])
        return out + b"\x0e"  # endchar

    rmove, rline, rcurve = 21, 5, 8
    charstrings = [
        b"\x0e",
        _t2_num(250) + b"\x0e",
        cs(600, ((100, 0), rmove), ((400, 0), rline), ((0, 400), rline), ((-400, 0), rline)),
        cs(700, ((80, 0), rmove), ((540, 0), rline), ((-60, 300, -200, 400, -270, 450), rcurve)),
        cs(650, ((250, 0), rmove), ((150, 0), rline), ((0, 250), rline), ((200, 0), rline), ((0, 150), rline),
           ((-200, 0), rline), ((0, 250), rline), ((-150, 0), rline), ((0, -250), rline), ((-200, 0), rline),
           ((0, -150), rline), ((200, 0), rline)),
    ]

    def index(items):
        offs = [1]
        for it in items:
            offs.append(offs[-1] + len(it))
        return struct.pack(">HB", len(items), 4) + struct.pack(f">{len(offs)}I", *offs) + b"".join(items)

    def int5(v):
        return b"\x1d" + struct.pack(">i", v)

    header, name_idx, strings, gsubrs = b"\x01\x00\x04\x04", index([b"Mini"]), b"\x00\x00", b"\x00\x00"
    top_len = len(index([int5(0) + int5(0) + b"\x12" + int5(0) + b"\x11"]))
    cs_off = len(header) + len(name_idx) + top_len + len(strings) + len(gsubrs)
    top = index([int5(0) + int5(cs_off) + b"\x12" + int5(cs_off) + b"\x11"])  # empty Private, CharStrings
    return header + name_idx + top + strings + gsubrs + index(charstrings)


def _t1_encrypt(plain: bytes, r: int) -> bytes:
    out = bytearray()
    for p in plain:
        c = p ^ (r >> 8)
        out.append(c)
        r = ((c + r) * 52845 + 22719) & 0xFFFF
    return bytes(out)


def _t1_charstring(*tokens) -> bytes:
    """Type 1 charstring bytes from small integers and operator codes
    (given as one-element tuples)."""
    out = bytearray()
    for t in tokens:
        if isinstance(t, tuple):
            out += bytes(t)
        elif -107 <= t <= 107:
            out.append(t + 139)
        elif 108 <= t <= 1131:
            out += bytes([247 + ((t - 108) >> 8), (t - 108) & 255])
        else:
            out += bytes([251 + ((-t - 108) >> 8), (-t - 108) & 255])
    return bytes(out)


def type1_program() -> bytes:
    """A Type 1 font program (PFA with a binary eexec section): its builtin
    /Encoding shows codes a, b, c as a square, a curved wedge and a bar."""
    hsbw, rmove, rline, rcurve, close, end = (13,), (21,), (5,), (8,), (9,), (14,)
    glyphs = [
        (".notdef", _t1_charstring(0, 500, hsbw, end)),
        ("sq", _t1_charstring(50, 600, hsbw, 50, 0, rmove, 500, 0, rline, 0, 500, rline, -500, 0, rline, close,
                              end)),
        ("wedge", _t1_charstring(40, 700, hsbw, 40, 0, rmove, 600, 0, rline, -100, 350, -300, 450, -450, 500,
                                 rcurve, close, end)),
        ("bar", _t1_charstring(100, 400, hsbw, 100, 0, rmove, 200, 0, rline, 0, 700, rline, -200, 0, rline, close,
                               end)),
    ]
    clear = (b"%!FontType1-1.0: SmokeType1 001.001\n/FontName /SmokeType1 def\n"
             b"/FontMatrix [0.001 0 0 0.001 0 0] readonly def\n/Encoding 256 array\n"
             b"0 1 255 {1 index exch /.notdef put} for\n"
             b"dup 97 /sq put\ndup 98 /wedge put\ndup 99 /bar put\n"
             b"readonly def\ncurrentdict end\ncurrentfile eexec\n")
    priv = b"/lenIV 4 def\n/CharStrings %d dict dup begin\n" % len(glyphs)
    for name, plain in glyphs:
        enc = _t1_encrypt(b"XXXX" + plain, 4330)
        priv += b"/%s %d RD %s ND\n" % (name.encode(), len(enc), enc)
    priv += b"end\nmark currentfile closefile\n"
    return clear + _t1_encrypt(b"YYYY" + priv, 55665)


def text_page(P, scale: bytes, pat_m, form, fn2, first_obj: int):
    """Page 3 of pdf_document: (content, resources, extra objects numbered
    from first_obj, glyphs painted).  Rows of text in every font kind of
    the port's reader (an embedded TrueType program as a simple font and as
    Type0 Identity-H, a bare CFF FontFile3, a Type 1 FontFile, a Type 3
    font with a d1 stencil and a d0 coloured glyph, Helvetica with no
    /Widths), render modes 0-3, kerning and the spacing operators, a
    rotated Tm, a vertical Identity-V column, mode 7 clipping an axial
    shading, a run under ca 0.5 and Multiply, and text inside a
    transparency group at ca 0.5, a soft-mask group and a tiling cell.
    Helvetica's glyphs count as painted only where a fallback face
    exists."""
    import zlib

    from coherence_tpu_torch.io.truetype import fallback_font_path

    N, R, S = P.Name, P.Ref, P.Stream
    tt = S({"Length1": 0, "Filter": N("FlateDecode")}, zlib.compress(truetype_program()))
    t1 = S({"Length1": 0, "Length2": 0, "Length3": 0}, type1_program())
    cff = S({"Subtype": N("Type1C")}, cff_program())
    codes = {0x20: 5, 0x41: 1, 0x42: 2, 0x43: 3, 0x44: 4}

    def descriptor(name, **program):
        return {"Type": N("FontDescriptor"), "FontName": N(name), "Flags": 4, "FontBBox": [0, -200, 1000, 900],
                "ItalicAngle": 0, "Ascent": 900, "Descent": -200, "CapHeight": 800, "StemV": 80, **program}

    def cid_font(vertical: bool):
        child = {"Type": N("Font"), "Subtype": N("CIDFontType2"), "BaseFont": N("SmokeTT"), "DW": 1000,
                 "W": [1, [1000, 1000, 400, 900, 300]],
                 "CIDSystemInfo": {"Registry": b"Adobe", "Ordering": b"Identity", "Supplement": 0},
                 "FontDescriptor": descriptor("SmokeTT", FontFile2=tt)}
        if vertical:
            child["W2"] = [1, [-1000, 500, 880, -1000, 500, 880, -450, 200, 880, -950, 450, 880, -300, 150, 880]]
        return {"Type": N("Font"), "Subtype": N("Type0"), "BaseFont": N("SmokeTT"),
                "Encoding": N("Identity-V" if vertical else "Identity-H"), "DescendantFonts": [child]}

    stencil = S({}, b"1000 0 0 0 800 800 d1 0 1 0 rg 0 0 800 800 re f")
    coloured = S({}, b"900 0 d0 1 0 0 rg 0 0 400 800 re f 0 0 1 rg 450 0 400 800 re f")
    font_objs = {
        "TT": {"Type": N("Font"), "Subtype": N("TrueType"), "BaseFont": N("SmokeTT"), "FirstChar": 32,
               "LastChar": 68, "Widths": [TT_ADVANCES[codes.get(c, 0)] for c in range(32, 69)],
               "FontDescriptor": descriptor("SmokeTT", FontFile2=tt)},
        "T0H": cid_font(False),
        "T0V": cid_font(True),
        "CF": {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("Mini"),
               "Encoding": {"Type": N("Encoding"), "Differences": [65, N("exclam"), N("quotedbl"), N("numbersign")]},
               "FontDescriptor": descriptor("Mini", FontFile3=cff)},
        "T1": {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("SmokeType1"), "FirstChar": 97,
               "LastChar": 99, "Widths": [600, 700, 400], "FontDescriptor": descriptor("SmokeType1", FontFile=t1)},
        "T3": {"Type": N("Font"), "Subtype": N("Type3"), "FontBBox": [0, 0, 1000, 1000],
               "FontMatrix": [0.001, 0, 0, 0.001, 0, 0], "CharProcs": {"st": stencil, "co": coloured},
               "Encoding": {"Type": N("Encoding"), "Differences": [97, N("st"), N("co")]},
               "FirstChar": 97, "LastChar": 98, "Widths": [1000, 900], "Resources": {}},
        "HV": {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("Helvetica")},
    }
    objects = {first_obj + i: fd for i, fd in enumerate(font_objs.values())}
    fonts = {name: R(first_obj + i) for i, name in enumerate(font_objs)}
    helvetica_paints = fallback_font_path("Helvetica") is not None
    painted = [0]

    def run(font: str, s: bytes, paints: bool = True) -> bytes:
        """A string operand of `font`, counting its painted glyphs."""
        if paints and (font != "HV" or helvetica_paints):
            if font in ("T0H", "T0V"):
                painted[0] += sum(1 for i in range(0, len(s), 2) if s[i + 1] != 5)
            else:
                painted[0] += sum(1 for c in s if c != 0x20)
        if font in ("T0H", "T0V"):
            return b"<" + s.hex().encode() + b">"
        return b"(" + s + b")"

    rows = {"TT": b"ABCD DCBA ", "T0H": bytes([0, 1, 0, 2, 0, 5, 0, 3, 0, 4, 0, 5]), "CF": b"ABC CBA ",
            "T1": b"abc cab ", "T3": b"abab ", "HV": b"Hello, text! "}
    colours = {"TT": b"0.1 0.1 0.5", "T0H": b"0.5 0.1 0.1", "CF": b"0.1 0.45 0.1", "T1": b"0.4 0.1 0.5",
               "T3": b"0.8 0.4 0.0", "HV": b"0.1 0.1 0.1"}
    c = [b"q " + scale + b"1 1 0.96 rg 0 0 1920 1080 re f BT 26 TL 40 1066 Td "]
    for k in range(30):
        font = list(rows)[k % 6]
        mode = (0, 0, 1, 2, 0)[k // 6]
        unit = rows[font]
        # A Type 3 glyph is a scene of its own: its rows are short.
        reps = 4 if font == "T3" else (272 if font == "T0H" else 136) // len(unit)
        line = unit * reps
        c.append(b"/%s 18 Tf %d Tr %s rg %s RG " % (font.encode(), mode, colours[font], colours[font]))
        if font == "TT":
            half = len(line) // 2
            c.append(b"T* [%s -250 %s 400 %s] TJ " % (run(font, line[:half]), run(font, line[half:-10]),
                                                       run(font, line[-10:])))
        elif font == "CF":
            c.append(b"1.5 Tc %s ' 0 Tc " % run(font, line))  # ' and " move to the next line
        elif font == "T1":
            c.append(b"4 0.5 %s \" 0 Tw 0 Tc " % run(font, line))
        elif font == "T3":
            c.append(b"T* 80 Tz %s Tj 100 Tz " % run(font, line))
        elif font == "HV":
            c.append(b"T* 3 Ts %s Tj 0 Ts " % run(font, line))
        else:
            c.append(b"T* %s Tj " % run(font, line))
    c.append(b"0 Tr ET ")
    # Mode 3 advances without painting; a rotated Tm; a vertical column.
    c.append(b"BT /TT 28 Tf 0 0 0 rg 40 170 Td 3 Tr %s Tj 0 Tr %s Tj ET "
             % (run("TT", b"ABCD", paints=False), run("TT", b"ABCDABCD")))
    c.append(b"BT /T1 30 Tf 0.2 0.5 0.7 rg 0.866 0.5 -0.5 0.866 420 60 Tm %s Tj ET " % run("T1", b"abcabcab"))
    c.append(b"BT /T0V 24 Tf 0.3 0.3 0.3 rg 1880 1050 Td %s Tj ET "
             % run("T0V", bytes([0, 1, 0, 2, 0, 3, 0, 4, 0, 5]) * 4))
    # Mode 7: the glyphs clip an axial shading until the Q.
    shading = {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [700, 0, 1100, 0],
               "Function": fn2((0.9, 0.1, 0.1), (0.1, 0.2, 0.9)), "Extend": [True, True]}
    c.append(b"q BT /TT 110 Tf 700 40 Td 7 Tr %s Tj ET /ShT sh Q " % run("TT", b"ABDC", paints=False))
    # ca 0.5 under Multiply over a backdrop.
    c.append(b"0.3 0.8 0.5 rg 1150 150 500 60 re f q /TxA gs BT /CF 44 Tf 0.9 0.2 0.2 rg 1160 160 Td %s Tj ET Q "
             % run("CF", b"ABCABCABC"))
    # A transparency group at ca 0.5 (folded as one layer list on the card).
    grp = form(b"0.95 0.85 0.3 rg 1150 240 560 120 re f BT /TT 36 Tf 0.1 0.1 0.6 rg 1160 280 Td %s Tj ET"
               % run("TT", b"ABCD ABCD ABCD"), [1150, 240, 1710, 360], group=True, Resources={"Font": fonts})
    c.append(b"q /Half gs /GrpT Do Q ")
    # A Luminosity soft mask drawn by text, and a tiling cell holding text.
    mask = form(b"1 g BT /T1 60 Tf 1160 400 Td %s Tj ET" % run("T1", b"abcabc", paints=False),
                [1150, 380, 1710, 480], group=True, Resources={"Font": fonts})
    c.append(b"q /SmT gs 0.1 0.3 0.8 rg 1150 380 560 100 re f Q ")
    cell = S({"Type": N("Pattern"), "PatternType": 1, "PaintType": 1, "TilingType": 1, "BBox": [0, 0, 60, 24],
              "XStep": 60, "YStep": 24, "Matrix": pat_m, "Resources": {"Font": fonts}},
             b"0.9 0.9 0.8 rg 0 0 60 24 re f BT /T1 12 Tf 0.5 0.1 0.1 rg 3 6 Td (abc) Tj ET")
    c.append(b"/Pattern cs /PT scn 1150 500 560 120 re f Q")
    res = {"Font": fonts, "Shading": {"ShT": shading}, "Pattern": {"PT": cell}, "XObject": {"GrpT": grp},
           "ExtGState": {"TxA": {"ca": 0.5, "BM": N("Multiply")}, "Half": {"ca": 0.5},
                         "SmT": {"SMask": {"Type": N("Mask"), "S": N("Luminosity"), "G": mask}}}}
    return b"".join(c), res, objects, painted[0]


def pdf_document(P, w: int, h: int, image_wh=PDF_IMAGE, seed: int = 0, stats=None):
    """(objects, trailer) of a three-page document built with the pdf module
    `P` (its Name, Ref and Stream), each page's MediaBox w x h; the content
    is laid out in a 1920x1080 design space and scaled to the page.  When
    `stats` is a dict, it receives the glyphs page 3 paints ("glyphs").

    Page 1 holds every graphics construct of the port's PDF reader: fills in
    Indexed, Separation (a type 2 function), DeviceN (a type 4 PostScript
    function) and Lab; an axial and a radial sh under a clip and the same
    two as shading patterns; a type 1 function shading; a type 4 mesh and
    a type 6 Coons mesh; a coloured and an uncoloured tiling pattern; a
    Luminosity and an Alpha soft mask; a transparency group at ca 0.5 and
    one under Multiply; paths under Multiply, Screen, Overlay and
    Difference; an annotation's /AP /N stream; a form hidden by an
    optional-content group beside a visible one.  Page 2 holds images: a
    Flate RGB image of image_wh samples, an Indexed image with an /SMask, an
    /ImageMask stencil, an inline image and a CCITT G4 image made with the
    port's ccitt_encode_g4.  Page 3 holds text (text_page)."""
    import zlib

    import numpy as np

    from coherence_tpu_torch.io.ccitt import ccitt_encode_g4

    N, R, S = P.Name, P.Ref, P.Stream
    sx, sy = w / 1920, h / 1080
    scale = f"{sx} 0 0 {sy} 0 0 cm ".encode()
    pat_m = [sx, 0.0, 0.0, sy, 0.0, 0.0]  # pattern space -> the page's default space
    rng = np.random.default_rng(seed)

    def fn2(c0, c1, n=1.0):
        return {"FunctionType": 2, "Domain": [0, 1], "C0": list(c0), "C1": list(c1), "N": n}

    def fn4(program: bytes, domain, rng_):
        return S({"FunctionType": 4, "Domain": list(domain), "Range": list(rng_)}, program)

    def form(content: bytes, bbox, group=False, **extra):
        d = {"Type": N("XObject"), "Subtype": N("Form"), "BBox": list(bbox), "Resources": {}}
        if group:
            d["Group"] = {"Type": N("Group"), "S": N("Transparency")}
        d.update(extra)
        return S(d, content)

    def cellbox(i):
        x, y = _cell(i)
        return [x, y, x + 130, y + 130]

    # --- page 1 --------------------------------------------------------------
    c = [b"q " + scale + b"0.93 0.95 0.98 rg 0 0 1920 1080 re f "]
    cs = {
        "Ix": [N("Indexed"), N("DeviceRGB"), 3, bytes([230, 40, 40, 40, 160, 60, 30, 60, 220, 250, 200, 30])],
        "Sep": [N("Separation"), N("Spot"), N("DeviceCMYK"), fn2((0, 0, 0, 0), (0.1, 0.7, 0.2, 0.05))],
        "DN": [N("DeviceN"), [N("A"), N("B")], N("DeviceRGB"),
               fn4(b"{ 2 copy add 2 div }", (0, 1, 0, 1), (0, 1, 0, 1, 0, 1))],
        "Lab": [N("Lab"), {"WhitePoint": [0.9505, 1.0, 1.089], "Range": [-100, 100, -100, 100]}],
        "PU": [N("Pattern"), N("DeviceRGB")],
    }
    for i, op in enumerate((b"/Ix cs 2 scn", b"/Sep cs 0.7 scn", b"/DN cs 0.3 0.9 scn", b"/Lab cs 55 60 -40 scn")):
        x, y = _cell(i)
        c.append(op + b" %d %d 130 130 re f " % (x, y))
    (ax, ay), (rx, ry) = _cell(4), _cell(5)
    shadings = {
        "ShA": {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [ax, ay, ax + 130, ay + 130],
                "Function": fn2((0.9, 0.1, 0.1), (0.1, 0.2, 0.9)), "Extend": [True, True]},
        "ShR": {"ShadingType": 3, "ColorSpace": N("DeviceRGB"), "Coords": [rx + 45, ry + 80, 5, rx + 65, ry + 65, 70],
                "Function": fn2((1, 1, 0.6), (0.6, 0, 0.3)), "Extend": [True, True]},
    }
    c.append(b"q %s W n /ShA sh Q q %d %d 130 130 re W n /ShR sh Q " % (_circle(ax + 65, ay + 65, 62), rx, ry))
    (px, py), (qx, qy) = _cell(6), _cell(7)
    patterns = {"PA": {"PatternType": 2, "Shading": dict(shadings["ShA"], Coords=[px, py, px + 130, py]), "Matrix": pat_m},
                "PR": {"PatternType": 2, "Matrix": pat_m,
                       "Shading": dict(shadings["ShR"], Coords=[qx + 65, qy + 65, 0, qx + 65, qy + 65, 65])}}
    c.append(b"/Pattern cs /PA scn %s f /PR scn %d %d 130 130 re f " % (_circle(px + 65, py + 65, 60), qx, qy))
    # Row 2: groups, soft masks, the function and mesh shadings, a tiling pattern.
    overlap = b"%d %d 80 80 re f %d %d 80 80 re f"
    gx, gy = _cell(8)
    mx, my = _cell(9)
    xobjects = {
        "GrpH": form(b"0.8 0.1 0.1 rg " + overlap % (gx, gy, gx + 50, gy + 50), cellbox(8), group=True),
        "GrpM": form(b"0.2 0.7 0.9 rg " + overlap % (mx, my, mx + 50, my + 50) + b" 0.9 0.8 0.1 rg %d %d 60 60 re f"
                     % (mx + 35, my + 5), cellbox(9), group=True),
    }
    c.append(b"q /Half gs /GrpH Do Q 0.5 0.9 0.4 rg %d %d 130 40 re f q /Mul gs /GrpM Do Q " % (mx, my + 45))
    lx, ly = _cell(10)
    kx, ky = _cell(11)
    ext = {
        "Half": {"ca": 0.5}, "Mul": {"BM": N("Multiply")}, "Scr": {"BM": N("Screen")}, "Ovl": {"BM": N("Overlay")},
        "Dif": {"BM": N("Difference")},
        "SmL": {"SMask": {"Type": N("Mask"), "S": N("Luminosity"),
                          "G": form(b"1 g %d %d 65 130 re f 0.4 g %d %d 65 65 re f" % (lx, ly, lx + 65, ly),
                                    cellbox(10), group=True)}},
        "SmA": {"SMask": {"Type": N("Mask"), "S": N("Alpha"),
                          "G": form(b"/Q gs 0 0 1 rg " + _circle(kx + 65, ky + 65, 55) + b" f", cellbox(11), group=True,
                                    Resources={"ExtGState": {"Q": {"ca": 0.6}}})}},
        "None": {"SMask": N("None")},
    }
    c.append(b"q /SmL gs 0.9 0.3 0.1 rg %d %d 130 130 re f Q q /SmA gs 0.1 0.6 0.2 rg %d %d 130 130 re f Q /None gs "
             % (lx, ly, kx, ky))
    fx, fy = _cell(12)
    shadings["ShF"] = {"ShadingType": 1, "ColorSpace": N("DeviceRGB"), "Domain": [0, 1, 0, 1],
                       "Matrix": [130, 0, 0, 130, fx, fy], "Function": fn4(b"{ 2 copy add 2 div }", (0, 1, 0, 1), (0, 1) * 3)}
    tx, ty = _cell(13)
    tri = [((tx + 5, ty + 5), (1, 0, 0)), ((tx + 125, ty + 20), (0, 1, 0)), ((tx + 40, ty + 125), (0, 0, 1))]
    free = b"".join(_mesh_bits([(0, 8)] + _mesh_xy(*p) + _mesh_rgb(*col)) for p, col in tri)
    free += _mesh_bits([(1, 8)] + _mesh_xy(tx + 125, ty + 125) + _mesh_rgb(1, 1, 0))
    mesh_d = {"ColorSpace": N("DeviceRGB"), "BitsPerCoordinate": 16, "BitsPerComponent": 8, "BitsPerFlag": 8,
              "Decode": [0, 1920, 0, 1080, 0, 1, 0, 1, 0, 1]}
    shadings["ShM"] = S(dict(mesh_d, ShadingType=4), free)
    cx0, cy0 = _cell(14)
    b = 12.0
    pts = [(cx0, cy0), (cx0 - b, cy0 + 43), (cx0 + b, cy0 + 87), (cx0, cy0 + 130), (cx0 + 43, cy0 + 130 + b),
           (cx0 + 87, cy0 + 130 - b), (cx0 + 130, cy0 + 130), (cx0 + 130 + b, cy0 + 87), (cx0 + 130 - b, cy0 + 43),
           (cx0 + 130, cy0), (cx0 + 87, cy0 + b), (cx0 + 43, cy0 - b)]
    shadings["ShC"] = S(dict(mesh_d, ShadingType=6), _mesh_bits(
        [(0, 8)] + [f for q in pts for f in _mesh_xy(*q)]
        + _mesh_rgb(1, 0, 0) + _mesh_rgb(0, 1, 0) + _mesh_rgb(0, 0, 1) + _mesh_rgb(1, 1, 0)))
    c.append(b"/ShF sh /ShM sh /ShC sh ")
    cx1, cy1 = _cell(15)
    cx2, cy2 = _cell(16)
    patterns["TC"] = S({"Type": N("Pattern"), "PatternType": 1, "PaintType": 1, "TilingType": 1, "BBox": [0, 0, 20, 20],
                        "XStep": 20, "YStep": 20, "Matrix": pat_m, "Resources": {}},
                       b"0.9 0.5 0.1 rg 0 0 10 10 re f 0.1 0.3 0.8 rg 10 10 10 10 re f")
    patterns["TU"] = S({"Type": N("Pattern"), "PatternType": 1, "PaintType": 2, "TilingType": 1, "BBox": [0, 0, 16, 16],
                        "XStep": 16, "YStep": 16, "Matrix": pat_m, "Resources": {}}, _circle(8, 8, 5) + b" f")
    c.append(b"/Pattern cs /TC scn %d %d 130 130 re f /PU cs 0.7 0.1 0.5 /TU scn %s f " % (cx1, cy1, _circle(cx2 + 65, cy2 + 65, 64)))
    # Row 3: blend modes over a two-colour backdrop, the annotation, optional content.
    for i, gs in zip(range(17, 21), (b"Mul", b"Scr", b"Ovl", b"Dif")):
        x, y = _cell(i)
        c.append(b"1 0.6 0.2 rg %d %d 130 65 re f 0.2 0.5 0.9 rg %d %d 130 65 re f q /%s gs 0.3 0.8 0.5 rg %s f Q "
                 % (x, y, x, y + 65, gs, _circle(x + 65, y + 65, 50)))
    hx, hy = _cell(22)
    vx, vy = _cell(23)
    xobjects["Hid"] = form(b"0 0 0 rg %d %d 130 130 re f" % (hx, hy), cellbox(22), OC=R(9))
    xobjects["Vis"] = form(b"0.4 0.2 0.6 rg %d %d 130 130 re f" % (vx, vy), cellbox(23), OC=R(8))
    c.append(b"/Hid Do /Vis Do Q")
    ann_x, ann_y = _cell(21)
    annot = {"Type": N("Annot"), "Subtype": N("Stamp"),
             "Rect": [ann_x * sx, ann_y * sy, (ann_x + 130) * sx, (ann_y + 130) * sy],
             "AP": {"N": form(b"0.9 0.9 0.2 rg 0 0 100 100 re f 0.8 0 0 RG 6 w 10 10 m 90 90 l S", (0, 0, 100, 100))}}
    res1 = {"ColorSpace": cs, "Shading": shadings, "Pattern": patterns, "ExtGState": ext, "XObject": xobjects}

    # --- page 2 --------------------------------------------------------------
    iw, ih = image_wh
    yy, xx = np.mgrid[0:ih, 0:iw]
    rgb = np.stack([xx * 255 // max(1, iw - 1), yy * 255 // max(1, ih - 1), (xx // 8 + yy // 8) % 2 * 200], -1)
    rgb = np.clip(rgb + rng.integers(-12, 12, rgb.shape), 0, 255).astype(np.uint8)
    im0 = S({"Type": N("XObject"), "Subtype": N("Image"), "Width": iw, "Height": ih, "ColorSpace": N("DeviceRGB"),
             "BitsPerComponent": 8, "Filter": N("FlateDecode")}, zlib.compress(rgb.tobytes()))
    lut = rng.integers(0, 256, 16 * 3).astype(np.uint8).tobytes()
    idx = rng.integers(0, 16, (64, 64)).astype(np.uint8)
    packed = ((idx[:, 0::2] << 4) | idx[:, 1::2]).tobytes()
    alpha = (np.add.outer(np.arange(64), np.arange(64)) * 2).clip(0, 255).astype(np.uint8)
    smask = S({"Type": N("XObject"), "Subtype": N("Image"), "Width": 64, "Height": 64, "ColorSpace": N("DeviceGray"),
               "BitsPerComponent": 8}, alpha.tobytes())
    im_ix = S({"Type": N("XObject"), "Subtype": N("Image"), "Width": 64, "Height": 64, "BitsPerComponent": 4,
               "ColorSpace": [N("Indexed"), N("DeviceRGB"), 15, lut], "SMask": smask}, packed)
    stencil = (np.add.outer(np.arange(96) // 12, np.arange(96) // 12) % 2).astype(np.uint8)
    im_m = S({"Type": N("XObject"), "Subtype": N("Image"), "Width": 96, "Height": 96, "ImageMask": True,
              "BitsPerComponent": 1}, np.packbits(stencil, axis=1).tobytes())
    fax = np.zeros((90, 120), dtype=int)
    for _ in range(12):
        r0, c0 = rng.integers(0, 80), rng.integers(0, 100)
        fax[r0: r0 + rng.integers(3, 20), c0: c0 + rng.integers(3, 30)] = 1
    im_g4 = S({"Type": N("XObject"), "Subtype": N("Image"), "Width": 120, "Height": 90, "ColorSpace": N("DeviceGray"),
               "BitsPerComponent": 1, "Filter": N("CCITTFaxDecode"),
               "DecodeParms": {"K": -1, "Columns": 120, "Rows": 90}}, ccitt_encode_g4([list(r) for r in fax], 120))
    inline = rng.integers(0, 256, (6, 8, 3)).astype(np.uint8).tobytes().hex().encode()
    c2 = (b"q " + scale + b"0.97 0.97 0.97 rg 0 0 1920 1080 re f q 1024 0 0 768 10 292 cm /Im0 Do Q "
          b"q 120 0 0 120 1045 930 cm /ImIx Do Q 0.8 0.1 0.3 rg q 120 0 0 120 1045 790 cm /ImM Do Q "
          b"q 120 0 0 90 1045 670 cm /ImG4 Do Q "
          b"q 120 0 0 90 1045 560 cm BI /W 8 /H 6 /BPC 8 /CS /RGB /F /AHx ID " + inline + b"> EI Q Q")
    res2 = {"XObject": {"Im0": im0, "ImIx": im_ix, "ImM": im_m, "ImG4": im_g4}}

    # --- page 3 --------------------------------------------------------------
    c3, res3, font_objects, glyphs = text_page(P, scale, pat_m, form, fn2, 12)
    if stats is not None:
        stats["glyphs"] = glyphs

    flate = {"Filter": N("FlateDecode")}
    objects = {
        1: {"Type": N("Catalog"), "Pages": R(2),
            "OCProperties": {"OCGs": [R(8), R(9)], "D": {"BaseState": N("ON"), "OFF": [R(9)]}}},
        2: {"Type": N("Pages"), "Kids": [R(3), R(5), R(10)], "Count": 3, "MediaBox": [0, 0, w, h]},
        3: {"Type": N("Page"), "Parent": R(2), "Contents": R(4), "Resources": res1, "Annots": [R(7)]},
        4: S(dict(flate), zlib.compress(b"".join(c))),
        5: {"Type": N("Page"), "Parent": R(2), "Contents": R(6), "Resources": res2},
        6: S(dict(flate), zlib.compress(c2)),
        7: annot,
        8: {"Type": N("OCG"), "Name": b"shown"},
        9: {"Type": N("OCG"), "Name": b"hidden"},
        10: {"Type": N("Page"), "Parent": R(2), "Contents": R(11), "Resources": res3},
        11: S(dict(flate), zlib.compress(c3)),
        **font_objects,
    }
    return objects, {"Root": R(1)}


def pdf_session(torch, device, path: str, kernels=None):
    """An Engine on `device` behind a RemoteDisplay and the port's client:
    OpenFile and a paint of the whole canvas, then for each further page
    PageDown and a paint of the whole canvas.  Returns (the client's image
    and the engine's framebuffer of each page, what was measured: with
    `kernels`, the fold_layers launches of each page)."""
    from coherence_tpu_torch.gui import app
    from coherence_tpu_torch.gui.window import RemoteDisplay
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.utils import profiling

    def server(conn, ready):
        eng = app.Engine(display=RemoteDisplay(conn), device=device)
        ready["eng"] = eng
        eng.run(resilient=False)

    cw, ch = PDF_CANVAS
    region.syncs = 0
    visited0 = profiling.counters["render.objects_visited"]
    folds = []
    folds_before = kernels.launches["fold_layers"] if kernels is not None else 0
    sv = Served(server)
    c = sv.c
    shots = []
    t0 = time.perf_counter()
    c.send_event("OpenFile", path)
    try:
        while not c.windows and c.handle_one():
            pass
    except (ConnectionError, OSError):
        sv.thread.join(10)
        sv.check()
        raise
    require(bool(c.windows), "pdf_pages: the server closed the session before opening its window")
    win = next(iter(c.windows))
    c.paint(win, 0, 0, cw, ch)
    first_paint_s = sv.await_refresh() - t0
    sv.barrier(win)

    def shot(name):
        sv.check()
        eng = sv.ready["eng"]
        img = c.windows[win].image
        fb = eng.wx.framebuffers[win]
        require(bool((img == fb[: img.shape[0], : img.shape[1]]).all()),
                f"pdf_pages: the client's image differs from the engine's framebuffer on {name}")
        shots.append((img.copy(), fb.copy()))
        if kernels is not None:
            folds.append(kernels.launches["fold_layers"] - folds_before - sum(folds))

    shot("page 1")
    turns = []
    for page in range(2, 4):
        t1 = time.perf_counter()
        c.send_event("KeyDown", win, 367)  # PageDown
        turns.append(sv.await_refresh() - t1)
        sv.drain()
        c.paint(win, 0, 0, cw, ch)
        sv.await_refresh()
        sv.barrier(win)
        require(sv.ready["eng"].docs[win][1] == page - 1, f"pdf_pages: PageDown did not turn to page {page}")
        shot(f"page {page}")
    stats = {"first_paint_s": first_paint_s, "page_turn_s": turns, "syncs": region.syncs,
             "objects_visited": profiling.counters["render.objects_visited"] - visited0,
             "window": list(c.windows[win].image.shape[1::-1])}
    if kernels is not None:
        stats["fold_layers_per_page"] = folds
    sv.close()
    return shots, stats


def debug_page(torch, device, path: str, out: str):
    """Page 3 of the file at `path` rendered once on `device` with
    render.pdf_debug_active set, its debug pages written to `out` by
    debugpdf.write_debug_pdf: (the file's bytes, the readbacks counted)."""
    from coherence_tpu_torch.io import pdf as P
    from coherence_tpu_torch.io import pdfgraphics as PG
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache, pdfscene
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import debugpdf

    pdf = P.pdf_of_file(path)
    scene = pdfscene.scene_of_graphic(pdf, PG.graphic_of_page(pdf, pdf.pages()[2]), device)
    cache.clear()
    debugpdf.clear_debug()
    syncs0 = region.syncs
    R.pdf_debug_active = True
    try:
        R.render_simple_scene(list(reversed(scene)), region.shape_of_box((1, 1, W, H), device), device)
    finally:
        R.pdf_debug_active = False
    syncs = region.syncs - syncs0
    debugpdf.write_debug_pdf(out)
    cache.clear()
    with open(out, "rb") as f:
        return f.read(), syncs


def pdf_pages(torch, dev, kernels):
    """The three-page document written by the port's writer, opened through
    a served Engine on the CPU and then on the card, with both caches
    emptied between; the client's images and the engine's framebuffer of
    each page equal, bit for bit.  Then the same document written again
    with AES-256 (R6, modern xref, an owner password) through a second
    served Engine on the card, equal to the plain file's pages; and page 3's
    debug pages, the card's file equal to the CPU's.  Returns the launch
    counts of the card's session of the plain file."""
    import os
    import tempfile

    from coherence_tpu_torch.io import pdf as P
    from coherence_tpu_torch.io.truetype import fallback_font_path
    from coherence_tpu_torch.scene import cache, fastframe
    from profile_general import issued

    t_phase = time.perf_counter()
    doc = {}
    pdf = P.Pdf(*pdf_document(P, W, H, stats=doc))
    plain = P.pdf_to_bytes(pdf)
    t0 = time.perf_counter()
    sealed = P.pdf_to_bytes(pdf, modern=True, encrypt={"revision": 6, "user_pw": b"", "owner_pw": b"pdf-pages"})
    encrypt_s = time.perf_counter() - t0
    require(b"/Encrypt" in sealed and b"/Encrypt" not in plain, "pdf_pages: the sealed file has no /Encrypt")
    with tempfile.TemporaryDirectory() as tmp:
        path, sealed_path = os.path.join(tmp, "pdf_pages.pdf"), os.path.join(tmp, "pdf_pages_aes256.pdf")
        for name, data in ((path, plain), (sealed_path, sealed)):
            with open(name, "wb") as f:
                f.write(data)
        cache.clear()
        scene_caches_clear()
        cpu_shots, cpu_stats = pdf_session(torch, "cpu", path)
        cache.clear()
        scene_caches_clear()
        zero_counts(torch, kernels)
        shots, stats = pdf_session(torch, dev, path, kernels)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        for page, (a, b) in enumerate(zip(shots, cpu_shots), start=1):
            require(bool((a[0] == b[0]).all()), f"pdf_pages: page {page}: the client's image differs from the CPU run's")
            require(bool((a[1] == b[1]).all()), f"pdf_pages: page {page}: the framebuffer differs from the CPU run's")
            require(bool((a[1] != a[1][0, 0]).any()), f"pdf_pages: page {page} painted nothing")
        require(not (shots[0][1] == shots[1][1]).all(), "pdf_pages: page 2 looks like page 1")
        for other in (0, 1):
            require(not (shots[2][1] == shots[other][1]).all(), f"pdf_pages: page 3 looks like page {other + 1}")
        require(stats["fold_layers_per_page"][2] >= 1, "pdf_pages: no fold_layers launch on page 3 (the text group)")
        tile_counts = {k: n for k, n in counts.items() if k not in GENERAL_KERNELS}
        require(not any(tile_counts.values()), f"pdf_pages: the general renderer launched a tile kernel: {counts}")

        cache.clear()
        scene_caches_clear()
        sealed_shots, sealed_stats = pdf_session(torch, dev, sealed_path)
        torch.cuda.synchronize()
        for page, (a, b) in enumerate(zip(sealed_shots, shots), start=1):
            require(bool((a[0] == b[0]).all() and (a[1] == b[1]).all()),
                    f"pdf_pages: page {page} of the encrypted file differs from the plain file's")

        cpu_debug, _ = debug_page(torch, "cpu", path, os.path.join(tmp, "debug_cpu.pdf"))
        card_debug, debug_syncs = debug_page(torch, dev, path, os.path.join(tmp, "debug_card.pdf"))
        require(card_debug == cpu_debug, "pdf_pages: the card's debug PDF differs from the CPU's")
        debug_pdf = P.pdf_of_bytes(card_debug)
        debug_pages = debug_pdf.pages()
        require(any(b"Do" in debug_pdf.page_content(p) for p in debug_pages), "pdf_pages: no debug page images a fragment")

        def all_pages():
            from coherence_tpu_torch.gui import app
            from coherence_tpu_torch.gui import window as Wn

            eng = app.Engine(device=dev)
            eng.event_handler((Wn.OPEN_FILE, path))
            view = eng.views[0]
            eng.render_rect(view.window, 0, 0, *PDF_CANVAS)
            for page in (1, 2):
                eng.goto_page(view, page)
                eng.render_rect(view.window, 0, 0, *PDF_CANVAS)

        cache.clear()
        n_issued = issued(torch, all_pages)
        cache.clear()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "pdf_pages", "page": [W, H], "canvas": list(PDF_CANVAS), "pages": 3, "file_bytes": len(plain),
          "encrypted_file_bytes": len(sealed), "encrypt": "AES-256 R6, modern xref", "encrypt_s": encrypt_s,
          "image_samples": list(PDF_IMAGE), "glyphs_painted": doc["glyphs"],
          "fallback_face": fallback_font_path("Helvetica"), **stats,
          "encrypted_first_paint_s": sealed_stats["first_paint_s"],
          "encrypted_page_turn_s": sealed_stats["page_turn_s"],
          "issued_launches_and_copies": n_issued, "launches": counts, "fold_layers_launches": counts["fold_layers"],
          "cpu_first_paint_s": cpu_stats["first_paint_s"], "cpu_page_turn_s": cpu_stats["page_turn_s"],
          "debug_pdf": {"bytes": len(card_debug), "pages": len(debug_pages), "syncs": debug_syncs},
          "seconds": seconds, "share_of_run": seconds / (time.perf_counter() - T_IMPORT),
          "equal": {"tolerance": 0, "client_images": 3, "framebuffers": 3, "encrypted_framebuffers": 3,
                    "debug_pdf_bytes": True}})
    return counts


def ptxas_info(log: str, function: str):
    """{"registers", "static_smem_bytes", "spill_bytes"} of each entry
    function of nvcc's ptxas output `log` whose name holds `function`, by
    its unmangled name; {} for an empty log (a library already built)."""
    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", ln)
        if m:
            name = m.group(1) or m.group(2)
            short = re.search(r"([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", name)
            current = None
            if function in name and short:  # a template's instantiations apart: caf_kernel<true>, ..<0,1>
                args = re.findall(r"L([ib])(\d+)E", short.group(2) or "")
                shown = [("true" if v == "1" else "false") if t == "b" else v for t, v in args]
                current = short.group(1) + (f"<{','.join(shown)}>" if shown else "")
            continue
        if current is None:
            continue
        row = out.setdefault(current, {"registers": None, "static_smem_bytes": 0, "spill_bytes": 0})
        if "spill stores" in ln:
            row["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            row["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            row["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return {name: row for name, row in out.items() if row["registers"] is not None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. Build.
    t0 = time.perf_counter()
    log = kernels.build()
    kernels.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]})

    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB
    timed = lion_kernels(torch, dev, scrub)
    lion = lion_path(torch, dev, kernels)
    counts4, timed["composite_runs"], full_4k, animated_4k = interactive_path(torch, dev, kernels, scrub)
    timed.update(brush_kernels(torch, dev, kernels, scrub, timed["launch_floor_ms"]))
    timed["tile_raster"] = tile_kernels(torch, dev, kernels, scrub, timed["launch_floor_ms"])
    timed["sprite_raster"] = sprite_kernels(torch, dev, kernels, scrub, timed["launch_floor_ms"])
    timed.update(region_kernels(torch, dev, kernels, scrub, timed["launch_floor_ms"]))
    counts_hsr, timed["composite_layers"] = layers_path(torch, dev, kernels, scrub)
    counts_mesh, mesh, udisp, ukey = mesh_4k_path(torch, dev, kernels)
    timed.update(mesh_kernels(torch, scrub, mesh, udisp, ukey))
    del udisp
    counts_lion17, dirty17, full17 = mesh_lion_path(torch, dev, kernels, scrub)
    counts_play = play_path(torch, dev, kernels)
    chain = animated_chain(torch, dev, kernels)
    from coherence_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(2, mesh_devices(torch, 2))
    emit({"phase": "dryrun", **dry, "seconds": time.perf_counter() - t0})
    del mesh
    counts_general, group_fold = general_lion(torch, dev, kernels)
    counts_filters, counts_demos = general_filters(torch, dev, kernels)
    counts_conv = convolve_1080p(torch, dev, kernels)
    stroked_tiles(torch, dev, kernels)
    counts_edits, lion_sprites = scene_edits(torch, dev, kernels)
    counts_frame, blur_fold = frame_path(torch, dev, kernels, lion_sprites)
    timed["fold_layers"] = fold_kernel(torch, dev, scrub, kernels,
                                       fold_shapes(torch, dev, lion_sprites["card"], group_fold, blur_fold))
    del scrub, lion_sprites, group_fold, blur_fold
    counts_serve, serve_check_full = serve_fast(torch, dev, kernels)
    counts_engine = serve_engine(torch, dev, kernels)
    counts_pdf = pdf_pages(torch, dev, kernels)

    require("jax" not in sys.modules, "jax was imported")
    jax_package = sorted(m for m in sys.modules if m == "coherence_tpu" or m.startswith("coherence_tpu."))
    require(not jax_package, f"modules of the JAX package were imported: {jax_package}")
    rows = [
        ("composite_dirty", SOURCE, "coherence_tpu/raster/tiled_scene.py:490", lion),
        ("composite_full", SOURCE, "coherence_tpu/raster/tiled_scene.py:379", lion),
        ("composite_runs", CSRC + "composite_runs.cu", "coherence_tpu/raster/tiled_scene.py:245", counts4),
        ("composite_layers", CSRC + "composite_layers.cu", "coherence_tpu/raster/pallas_compositor.py:101",
         counts_hsr),
        ("composite_full_banded", CSRC + "banded.cu", "coherence_tpu/raster/tiled_scene.py:1358", counts_mesh),
        ("composite_dirty_banded", CSRC + "banded.cu", "coherence_tpu/raster/tiled_scene.py:1516", counts_mesh),
    ]
    line = []
    for kname, source, replaces, counts in rows:
        t = timed[kname]
        line.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[kname], "launches_4k": counts4[kname], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     # No one PyTorch call composites a front-to-back piece list with an early stop.
                     "library_ms": None, "bytes": t["bytes"], "share": t["bound_ms"] / t["ms"],
                     "stripe_count_bytes": t["stripe_count_bytes"], "depth": t["depth"]})
        for extra in ("banded_one_band_ms", "composite_full_ms", "unbanded_ms"):
            if extra in t:
                line[-1][extra] = t[extra]
    line[1]["also_replaces"] = "coherence_tpu/raster/tiled_scene.py:143"
    for row in line[:2]:
        row["launches_serve_fast"] = counts_serve[row["name"]]
    line[1]["full_render_check_launches"] = serve_check_full  # after the session, on its view
    line[1].update({"ms_4k": full_4k["ms"], "banded_one_band_ms_4k": full_4k["banded_one_band_ms"],
                    "bytes_4k": full_4k["bytes"], "bound_ms_4k": full_4k["bound_ms"],
                    "share_4k": full_4k["bound_ms"] / full_4k["ms"], "depth_4k": full_4k["depth"]})
    line[4]["also_replaces"] = "coherence_tpu/raster/tiled_scene.py:1385"
    for row in line[4:]:
        row["launches_4k"] = counts_mesh[row["name"]]
        row["launches_lion_17_bands"] = counts_lion17[row["name"]]
    for row, t in ((line[4], full17), (line[5], dirty17)):
        row.update({"ms_lion_17_bands": t["ms"], "unbanded_ms_lion_17_bands": t["unbanded_ms"],
                    "bytes_lion_17_bands": t["bytes"], "bound_ms_lion_17_bands": t["bound_ms"],
                    "share_lion_17_bands": t["bound_ms"] / t["ms"]})
    fold = timed["fold_layers"]
    line.append({"name": "fold_layers", "route": "cuda", "source": CSRC + "fold_layers.cu",
                 "replaces": "coherence_tpu/raster/framepath.py:371", "pallas": False,
                 "launches": counts_frame["fold_layers"], "launches_general_lion": counts_general["fold_layers"],
                 "launches_scene_edits": counts_edits["fold_layers"], "launches_serve_engine": counts_engine["fold_layers"],
                 "launches_pdf_pages": counts_pdf["fold_layers"],
                 "max_abs_err": fold["max_abs_err"], "ms": fold["ms"], "plain_ms": fold["plain_ms"],
                 "bound_ms": fold["bound_ms"], "bound_by": "bytes",
                 # No one PyTorch call folds masked, offset layers front to back with an early stop.
                 "library_ms": None, "bytes": fold["bytes"], "share": fold["share"],
                 "shapes": {name: {key: row[key] for key in ("window", "layers", "open_before", "ms", "plain_ms",
                                                             "bound_ms", "share")}
                            for name, row in fold["shapes"].items()}})
    animated_rows = (
        # No one PyTorch call computes an exact integer separable blur with a divide and a clamp after each pass.
        ("blur_blend", CSRC + "blur_blend.cu", "coherence_tpu/scene/fastframe.py:1158",
         ["coherence_tpu/raster/framepath.py:310", "coherence_tpu/raster/framepath.py:475",
          "coherence_tpu/raster/framepath.py:429"]),
        # No one PyTorch call packs a raster and cuts it into pieces at atlas slots.
        ("shatter_into", CSRC + "shatter.cu", "coherence_tpu/raster/tiled_scene.py:62",
         ["coherence_tpu/raster/tiled_scene.py:45"]),
    )
    for kname, source, replaces, also in animated_rows:
        t, t4 = timed[kname], animated_4k[kname]
        line.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces, "also_replaces": also,
                     "pallas": False, "launches": lion[kname], "launches_4k": counts4[kname],
                     "launches_mesh_4k": counts_mesh[kname], "launches_lion_17_bands": counts_lion17[kname],
                     "launches_play_animated": counts_play[kname], "launches_frame_path": counts_frame[kname],
                     "launches_serve_fast": counts_serve[kname],
                     "max_abs_err": max(t["max_abs_err"], t4["max_abs_err"]), "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None, "bytes": t["bytes"],
                     "share": t["share"], "ms_4k": t4["ms"], "plain_ms_4k": t4["plain_ms"],
                     "bound_ms_4k": t4["bound_ms"], "bytes_4k": t4["bytes"], "share_4k": t4["share"]})
    line[-1]["animated_chain"] = {name: {key: row[key] for key in ("frames", "reps", "ms_per_frame", "readings")}
                                  for name, row in chain.items()}  # the frame's queued chain, headed by shatter_into
    rect = timed["blur_blend"]["rect"]
    line[-2]["rect_1080p"] = {key: rect[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes", "share")}
    line[-2]["unpacked_ms"] = timed["blur_blend"]["unpacked_ms"]  # the same window over FrameBuffer's unpacked content
    stamp, smear = timed["brush_stamp"], timed["smear_walk"]
    # No one PyTorch call stamps a brush patch with alpha_over in order, nor walks a smear.
    line.append({"name": "brush_stamp", "route": "cuda", "source": CSRC + "brush_stamp.cu",
                 "replaces": "coherence_tpu/raster/brush_tiles.py:62", "also_replaces": ["coherence_tpu/raster/brush.py:182"],
                 "pallas": False, "launches": counts4["brush_stamp"],
                 "launches_general_filter_demos": {n: c["brush_stamp"] for n, c in counts_demos.items() if "brush_stamp" in c},
                 "max_abs_err": stamp["max_abs_err"], "ms": stamp["ms"], "plain_ms": stamp["plain_ms"],
                 "bound_ms": stamp["bound_ms"], "bound_by": stamp["bound_by"], "library_ms": None, "bytes": stamp["bytes"],
                 "share": stamp["share"], "kernel_ms": stamp["kernel_ms"], "copy_ms": stamp["copy_ms"],
                 "kernel_share": stamp["kernel_share"], "blocks": stamp["blocks"],
                 "stamp_list_max": stamp["stamp_list_max"], "stamp_list_mean": stamp["stamp_list_mean"],
                 "patch_smem": stamp["patch_smem"], "blocks_per_sm": stamp["blocks_per_sm"],
                 "layout_bytes": stamp["layout_bytes"], "host_ms": stamp["host_ms"], "shape": stamp["shape"],
                 "shapes": stamp["shapes"]})
    line.append({"name": "smear_walk", "route": "cuda", "source": CSRC + "smear.cu",
                 "replaces": "coherence_tpu/raster/brush.py:324", "pallas": False,
                 "launches": counts_demos["smear"].get("smear_walk", 0), "max_abs_err": smear["max_abs_err"],
                 "ms": smear["ms"], "plain_ms": smear["plain_ms"], "bound_ms": smear["bound_ms"],
                 "bound_by": smear["bound_by"], "library_ms": None, "bytes": smear["bytes"], "share": smear["share"],
                 "step_bytes": smear["step_bytes"], "serial_steps": smear["serial_steps"],
                 "chain_floor_ms": smear["chain_floor_ms"], "mode": smear["mode"], "window": smear["window"],
                 "reloads": smear["reloads"], "device_from": smear["device_from"],
                 "global_r120": smear["global_r120"]})
    tile = timed["tile_raster"]
    # No one PyTorch call turns span lists into Gaussian-matted packed pieces.
    line.append({"name": "tile_raster", "route": "cuda", "source": CSRC + "tile_raster.cu",
                 "replaces": "coherence_tpu/raster/tile_raster.py:115",
                 "also_replaces": ["coherence_tpu/raster/tile_raster.py:120", "coherence_tpu/raster/tile_raster.py:79",
                                   "coherence_tpu/raster/tile_raster.py:102"],
                 "pallas": False, "launches": lion["tile_raster_build"], "launches_4k_build": counts4["tile_raster_build"],
                 "launches_4k_zooms": counts4["tile_raster_zooms"], "launches_4k_prefetch": counts4["tile_raster_prefetch"],
                 "launches_4k": counts4["tile_raster"], "max_abs_err": tile["max_abs_err"], "ms": tile["ms"],
                 "plain_ms": tile["plain_ms"], "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
                 "library_ms": None, "bytes": tile["bytes"], "share": tile["share"], "blocks": tile["blocks"],
                 "items": tile["items"], "units": tile["units"], "fringe_pixels": tile["fringe_pixels"],
                 "layout_bytes": tile["layout_bytes"], "blocks_per_sm": tile["blocks_per_sm"],
                 "host_ms": tile["host_ms"], "flush_issued": tile["flush_issued"], "config5": tile["config5"]})
    sprite = timed["sprite_raster"]
    # No one PyTorch call turns span lists into Gaussian-matted sprites or a matte.
    line.append({"name": "sprite_raster", "route": "cuda", "source": CSRC + "sprite_raster.cu",
                 "replaces": "coherence_tpu/scene/fastframe.py:170",
                 "also_replaces": ["coherence_tpu/raster/aa.py:170", "coherence_tpu/raster/aa.py:144",
                                   "coherence_tpu/raster/aa.py:93"],
                 "pallas": False, "launches": counts_general["sprite_raster_rebuild"],
                 "launches_general_lion": counts_general["sprite_raster"],
                 "launches_fold_route": counts_general["sprite_raster_fold_route"],
                 "launches_general_filter_demos": {n: c.get("sprite_raster", 0) for n, c in counts_demos.items()},
                 "launches_general_filters": counts_filters.get("sprite_raster", 0),
                 "launches_serve_engine": counts_engine["sprite_raster"],
                 "launches_pdf_pages": counts_pdf["sprite_raster"],
                 "max_abs_err": sprite["max_abs_err"], "ms": sprite["ms"], "copy_ms": sprite["copy_ms"],
                 "plain_ms": sprite["plain_ms"], "bound_ms": sprite["bound_ms"], "bound_by": sprite["bound_by"],
                 "library_ms": None, "bytes": sprite["bytes"], "share": sprite["share"], "host_ms": sprite["host_ms"],
                 "members": sprite["members"], "groups": sprite["groups"], "units": sprite["units"],
                 "spans": sprite["spans"], "fringe_pixels": sprite["fringe_pixels"],
                 "blocks_per_sm": sprite["blocks_per_sm"], "issued": sprite["issued"], "mattes": sprite["mattes"]})
    region_rows = (
        # No one PyTorch call composites two masked, offset operands with an operator and reports a predicate.
        ("caf", "region_ops.cu", "coherence_tpu/raster/region.py:611", []),
        # No one PyTorch call gives the bounding box of a mask's set cells.
        ("tight_bounds", "region_ops.cu", "coherence_tpu/raster/region.py:459", []),
        # A bloat's library_ms is torch.nn.functional.max_pool2d's (stride 1, padding (ry, rx)); none erodes.
        ("box_morph", "region_ops.cu", "coherence_tpu/raster/region.py:690",
         ["coherence_tpu/raster/region.py:715", "coherence_tpu/raster/region.py:665"]),
        # No one PyTorch call convolves exactly in integers with a divide and a clamp after each pass.
        ("convolve_canvas", "convolve.cu", "coherence_tpu/raster/convolve.py:195", []),
    )
    for kname, source, replaces, also in region_rows:
        t = timed[kname]
        rows_k = t["rows"]
        main_row = max(rows_k, key=lambda r: (not r.get("synthetic"), r.get("library_ms") is not None, r["bytes"]))
        line.append({"name": kname, "route": "cuda", "source": CSRC + source, "replaces": replaces,
                     "also_replaces": also, "pallas": False, "launches": counts_filters.get(kname, 0),
                     "launches_per_incremental_frame": counts_filters["counted_frame"]["incremental_launches"].get(kname, 0),
                     "issued_per_incremental_frame": counts_filters["counted_frame"]["incremental"],
                     "launches_general_lion": counts_general["region_rebuild"][kname],
                     "launches_fold_route": counts_general["region_fold_route"][kname],
                     "launches_general_filter_demos": {n: c.get(kname, 0) for n, c in counts_demos.items()},
                     "launches_convolve_1080p": counts_conv.get(kname, 0),
                     "launches_scene_edits": counts_edits.get(kname, 0), "launches_serve_engine": counts_engine[kname],
                     "launches_pdf_pages": counts_pdf[kname], "calls_checked": t["calls"],
                     "max_abs_err": t["max_abs_err"], "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                     "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                     "library_ms": main_row["library_ms"], "bytes": main_row["bytes"], "share": main_row["share"],
                     "shapes": rows_k})
        # the second designs' registers and static shared memory
        line[-1]["ptxas"] = ptxas_info(log, "convolve_" if kname == "convolve_canvas" else f"{kname}_")
    for row in line:  # an empty kernel's launch, timed as each kernel is: the floor under every time
        row["launch_floor_ms"] = timed["launch_floor_ms"]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
