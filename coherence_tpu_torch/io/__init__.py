"""PDF input: the port's copies of ``coherence_tpu.io.pdf`` and
``coherence_tpu.io.pdfgraphics``, trimmed to what the port's scenes read."""
