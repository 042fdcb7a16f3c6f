"""portbench: the benchmark of coherence_tpu_torch on an NVIDIA H100 (see README.md)."""
