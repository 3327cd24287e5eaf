"""processor.host_us: the host's time inside the program's call (the
processor and everything it enqueues), with no sync, mean over the
window's calls. Read in the traced run, so it includes the profiler's cost
on each operation."""


def read(record):
    if not record.host_call_s:
        return None
    return sum(record.host_call_s) / len(record.host_call_s) * 1e6
