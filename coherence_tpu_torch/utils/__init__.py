"""Observability, debugging and persistence utilities.

Parity + upgrades over SURVEY.md §5 (the reference's auxiliary subsystems):
counters/timers + the profiler (§5.1), the debug-PDF visual channel
(§4/sprite.ml:1996-2165), sprite marshalling to disk (sprite.ml:377-400),
and the flag/config registry (§5.6).

The port's ``utils``: the same names as ``coherence_tpu.utils``, with
``trace`` recording a ``torch.profiler`` trace and the sprite loaders
taking the device the raster is to live on.
"""

from .debugpdf import (  # noqa: F401
    add_debug_shape,
    add_debug_sprite,
    clear_debug,
    write_debug_page,
    write_debug_pdf,
)
from .persist import load_sprite, save_sprite, load_shape, save_shape  # noqa: F401
from .profiling import counters, counter, time_block, timers, trace, report  # noqa: F401
from . import flags  # noqa: F401
