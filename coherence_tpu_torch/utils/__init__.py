"""Flags and counters: the port's copies of ``coherence_tpu.utils.flags``
and of the counters of ``coherence_tpu.utils.profiling``."""
