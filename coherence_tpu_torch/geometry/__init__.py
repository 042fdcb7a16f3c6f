"""Paths and shapes: the port's copies of ``coherence_tpu.geometry.path``
and ``coherence_tpu.geometry.shapes``, trimmed to what the port uses."""
