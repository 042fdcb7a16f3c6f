"""Paths, shapes, the stroker and dash splitting: the port's copies of
``coherence_tpu.geometry.path`` (trimmed to what the port uses), and of
``coherence_tpu.geometry.shapes`` and ``coherence_tpu.geometry.dash``
(whole)."""
