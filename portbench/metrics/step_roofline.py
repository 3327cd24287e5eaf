"""step_roofline: the whole call's least time (the resident audio it reads
once, its display output written once, its state read and written once,
the read-back across the host link; the session's ``work()["step"]``, at
the published peaks) over the device time of every kernel and copy in the
traced window a call, in percent. It holds whatever kernels a later change
fuses or removes."""

from portbench.peaks import least_seconds


def read(record):
    if record.trace is None or "step" not in record.work:
        return None
    device_s = sum(e - s for _, s, e in record.trace.device)
    if device_s <= 0:
        return None
    return least_seconds(record.work["step"]) * record.calls / device_s * 100.0
