"""display_map_roofline: kernel B's least time a call (magnitudes, plan
tables and state in once, display values and state out once; the
session's ``work()["display_map"]``, at the published peaks) over the device
time of B's fused entry a call, in percent."""

import re

from portbench.peaks import least_seconds

KERNEL = re.compile(r"\bdisplay_map_kernel\b")


def read(record):
    if record.trace is None or "display_map" not in record.work:
        return None
    device_s = sum(e - s for name, s, e in record.trace.kernels() if KERNEL.search(name))
    if device_s <= 0:
        return None
    return least_seconds(record.work["display_map"]) * record.calls / device_s * 100.0
