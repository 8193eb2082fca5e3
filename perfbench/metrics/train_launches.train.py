"""Device operations launched per training step in a traced window: every
kernel, copy and fill the device ran, over the steps traced (their batches
were made before the trace began)."""


def read(trace):
    n = trace.work.get("steps")
    if not n or not trace.device_ops:
        return None
    return len(trace.device_ops) / n
