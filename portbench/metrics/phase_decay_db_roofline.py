"""phase_decay_db_roofline: kernel G's least time a call (the PHASE values
read once, the display values written once, the mid's and the phase's
states read and written once; the session's ``work()["phase_decay_db"]``,
at the published peaks) over the device time of G's kernels a call (its
walk, its walk pass where T is split, its T = 1 tick), in percent."""

import re

from portbench.peaks import least_seconds

KERNEL = re.compile(r"\bphase_(decay_db|walk|tick)_kernel\b")


def read(record):
    if record.trace is None or "phase_decay_db" not in record.work:
        return None
    device_s = sum(e - s for name, s, e in record.trace.kernels() if KERNEL.search(name))
    if device_s <= 0:
        return None
    return least_seconds(record.work["phase_decay_db"]) * record.calls / device_s * 100.0
