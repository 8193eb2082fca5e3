"""The share of the device's busy time spent in the elementwise and cast
class of kernels (``harness/trace.CLASSES``)."""


def read(trace):
    busy = trace.busy_s
    if not busy:
        return None
    return 100.0 * trace.class_s().get("elementwise/cast", 0.0) / busy
