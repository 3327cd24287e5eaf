"""latency_p95_ms: the 95th percentile, over every call of the window, of
the time from handing a call to the program until its read-back display
data is on the host, by the host's clock."""

import numpy as np


def read(record):
    return float(np.percentile(record.latencies_s, 95)) * 1e3 if record.latencies_s else None
