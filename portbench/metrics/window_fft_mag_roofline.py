"""window_fft_mag_roofline: kernel A's least time a call (its frames read
once, its magnitudes written once, its FFT's operations; the session's
``work()["window_fft_mag"]``, at the published peaks) over the device time
of the one-block form's kernel a call, in percent."""

import re

from portbench.peaks import least_seconds

KERNEL = re.compile(r"\bwindow_fft_mag_kernel\b")


def read(record):
    if record.trace is None or "window_fft_mag" not in record.work:
        return None
    device_s = sum(e - s for name, s, e in record.trace.kernels() if KERNEL.search(name))
    if device_s <= 0:
        return None
    return least_seconds(record.work["window_fft_mag"]) * record.calls / device_s * 100.0
