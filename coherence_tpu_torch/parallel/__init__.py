"""Multi-device scale-out: the frame's tile rows split into bands over a mesh.

Compositing is spatially local, so each band composites its own tiles from
its own local atlas (``raster.tiled_scene.BandedAtlas``) with no traffic
between bands; the blur needs halo rows at band borders, which the port
copies explicitly.  The dry-run twin of the JAX package's
``__graft_entry__.dryrun_multichip`` is ``parallel.dryrun``.
"""

from .mesh import (  # noqa: F401
    Mesh,
    RowSharded,
    blur_pass,
    composite_step,
    make_mesh,
    sharded_blur,
    sharded_render_step,
)
