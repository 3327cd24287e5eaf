"""processor.launches_per_call: device kernels in the traced window over
the window's calls (the read-back's gather included; copies not)."""


def read(record):
    if record.trace is None or not record.calls:
        return None
    kernels = record.trace.kernels()
    return len(kernels) / record.calls if kernels else None
