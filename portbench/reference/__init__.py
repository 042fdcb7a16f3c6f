"""The plain reference: the renderer's geometry, sweep, anti-aliasing, tile
paint rule, brush strokes, composite and blur in Python, NumPy and plain
PyTorch.  It imports nothing of coherence_tpu_torch, coherence_tpu or JAX."""
