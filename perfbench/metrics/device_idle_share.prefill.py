"""The share of the traced window in which no operation ran on the device:
1 − (the union of device operation intervals) / (the window)."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
