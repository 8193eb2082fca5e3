"""Device operations launched per request in a traced prefill window: every
kernel, copy and fill the device ran, over the requests traced (the prompts
were made before the trace began).  An exact count where every request
launches alike."""


def read(trace):
    n = trace.work.get("requests")
    if not n or not trace.device_ops:
        return None
    return len(trace.device_ops) / n
