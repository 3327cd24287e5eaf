"""device.idle_pct: the share of the traced window in which no kernel or
copy ran on the card, from the profiler's timeline of that window."""


def read(record):
    if record.trace is None or record.trace.window_s <= 0 or not record.trace.device:
        return None
    return (1.0 - record.trace.busy_s() / record.trace.window_s) * 100.0
