"""coherence_tpu_torch — the PyTorch and CUDA port of coherence_tpu.

The JAX package ``coherence_tpu`` is the reference; this package mirrors its
layout module for module and holds to it bit for bit (the renderer's colour
math is exact integer arithmetic).  Plain tensor code is PyTorch; each
Pallas TPU kernel on the ported path is a hand-written Hopper kernel under
``kernels/``, with a plain PyTorch version beside it that CPU tensors use.

Ported so far: the animated blur-filtered tiled frame path with brush
strokes, zoom, the dense layer-stack compositor and the banded multi-device
path; the general renderer with its coherence cache, every fill, stroke,
filter and demo scene; the serving surface (the wire protocol, the window
system, the Engine, FastSession, undo, checkpoint); and the PDF stack
(reader, writer, encryption, graphics, images, text):
  colour                         — packed colours, exact tensor compositing,
                                   the scalar and array colour operations
  raster/compositor              — packed-pixel format, `over`, layer stacks
  raster/region                  — dense shapes and sprites, set algebra, caf,
                                   bloat and erode, canvases, the sync counter
  raster/fills, blend            — every fill; the PDF blend modes
  raster/scanline, aa            — host sweep, Gaussian-matte AA coverage, the
                                   AA polygon sprite
  raster/tile_raster             — paths -> frame-aligned atlas pieces
  raster/brush, brush_tiles      — brush strokes and smears; strokes -> pieces
  raster/tiled_scene             — atlas, piece lists, tile compositor wrappers
  raster/convolve, framepath     — exact integer convolution, the filter blend
  scene/render, cache, filters   — scene model, the hidden-surface renderer,
                                   dirty regions, picking, the coherence cache,
                                   the filters
  scene/pdfscene, pdftext, examples, icons — PDF scenes and text, demo and
                                   benchmark scenes, icons
  scene/fastframe                — scene build and its cache, DeviceView
                                   (zoom, prefetch, use_mesh), FilteredDisplay
                                   (play_animated)
  scene/undo, checkpoint         — undo and redo; scenes and views as JSON, the
                                   same text as the JAX package writes
  gui/wire, talk, messages, client, tkclient — the wire format, the TCP
                                   transport, the display clients (copies)
  gui/window, app, fastserver    — the window system, the Engine, FastSession:
                                   on the card unless the caller names the CPU
  parallel/mesh, dryrun          — row-band meshes of one process, halo
                                   exchange, the multi-band dry run
  coord, transform, ident        — copies of the JAX package's host modules
  geometry/, io/, native_lib     — paths, shapes, strokes, dashes, the PDF
                                   reader and writer, encryption, the image
                                   decoders and font programs, the native
                                   sweep and blit
  utils/flags, profiling, png, persist, debugpdf — flags, counters and the
                                   profiler trace, PNG and .npz files, the
                                   debug pages
  kernels/                       — CUDA build, binding, launch counters
  convert                        — JAX-side state (as numpy) -> port objects

It imports nothing of ``coherence_tpu`` and never ``jax``: the host modules
it needs (coord, transform, ident, geometry, io, native_lib with the native
library under native/, and the gui's wire, talk, messages and clients) are
its own copies, each naming the JAX module it copies.
"""

__version__ = "0.1.0"
