"""readback.us: the device time of the device-to-host copies a call (the
display data read back to pinned host memory), from the profiler."""


def read(record):
    if record.trace is None or not record.calls:
        return None
    copies = record.trace.device_to_host()
    return sum(e - s for _, s, e in copies) / record.calls * 1e6 if copies else None
