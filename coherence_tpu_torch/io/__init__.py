"""PDF import and export: the port's copies of the JAX package's ``io``
modules (the reader and writer, encryption, the content-stream interpreter,
the image decoders and the font programs)."""
