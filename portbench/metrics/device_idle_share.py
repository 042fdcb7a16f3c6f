"""device_idle_share: percent of the traced window in which no kernel or
copy ran on the device (the union of their intervals from the trace)."""


def read(traced):
    if traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)
