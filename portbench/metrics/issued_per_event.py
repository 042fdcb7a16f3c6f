"""issued_per_event: the CUDA runtime's launch and copy calls in the traced
window (portbench/stats.py's RUNTIME_CALLS), less the benchmark's own
snapshot copies, per event."""


def read(traced):
    if not traced.n_events:
        return None
    return traced.issued / traced.n_events
