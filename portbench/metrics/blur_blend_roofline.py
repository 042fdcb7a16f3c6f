"""blur_blend_roofline: percent of blur_blend's (B1's) roofline that it
reached in the traced window: its bound summed over the windows it ran
(portbench/bounds.py's blur_bound, from each window's shapes, against the
H100 SXM's 3.35 TB/s and int32 rate) over its summed device time from the
trace.  Nothing where it ran no window, and nothing where the trace holds
another number of B1's window launches than its wrapper saw calls (a
replayed graph would add time and no bound)."""


def read(traced):
    if not traced.b1_bound_ms or not traced.b1_device_ms:
        return None
    return 100.0 * traced.b1_bound_ms / traced.b1_device_ms
