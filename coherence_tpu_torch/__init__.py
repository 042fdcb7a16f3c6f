"""coherence_tpu_torch — the PyTorch and CUDA port of coherence_tpu.

The JAX package ``coherence_tpu`` is the reference; this package mirrors its
layout module for module and holds to it bit for bit (the renderer's colour
math is exact integer arithmetic).  Plain tensor code is PyTorch; each
Pallas TPU kernel on the ported path is a hand-written Hopper kernel under
``kernels/``, with a plain PyTorch version beside it that CPU tensors use.

Ported so far, the animated blur-filtered tiled frame path, with brush
strokes, zoom, the dense layer-stack compositor and the banded multi-device
path:
  colour                         — packed colours and exact tensor compositing
  raster/compositor              — packed-pixel format, `over`, layer stacks
  raster/region, fills           — boxes, sprites, box dilation, plain fills
  raster/scanline, aa            — host sweep, Gaussian-matte AA coverage
  raster/tile_raster             — paths -> frame-aligned atlas pieces
  raster/brush, brush_tiles      — brush host math; strokes -> atlas pieces
  raster/tiled_scene             — atlas, piece lists, tile compositor wrappers
  raster/convolve, framepath     — exact integer blur and the filter blend
  scene/render, pdfscene, examples — scene model, PDF scenes, benchmark scenes
  scene/fastframe                — scene build and its cache, DeviceView
                                   (zoom, prefetch, use_mesh), FilteredDisplay
                                   (play_animated)
  parallel/mesh, dryrun          — row-band meshes of one process, halo
                                   exchange, the multi-band dry run
  coord, transform, ident        — copies of the JAX package's host modules
  geometry/, io/, native_lib     — paths, shapes, PDF input, the native sweep
  kernels/                       — CUDA build, binding, launch counters
  convert                        — JAX-side state (as numpy) -> port objects

It imports nothing of ``coherence_tpu`` and never ``jax``: the host modules
it needs (coord, transform, ident, geometry, io, native_lib and the native
sweep library under native/) are its own trimmed copies, each naming the
JAX module it copies.
"""

__version__ = "0.1.0"
