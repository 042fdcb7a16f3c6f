"""host_ms_per_event: the mean host time of an event's calls, from the call's
start to its return before the synchronize (the benchmark's clock)."""


def read(traced):
    if not traced.host_ms:
        return None
    return sum(traced.host_ms) / len(traced.host_ms)
