"""processor.self_host_us: the processor's own host time a call: the span
``spectrum.process`` or ``spectrogram.step`` less the spans directly under
it (the device ring, the kernel wrappers, the colour map); mean over the
traced window's calls, in microseconds (``portbench.program_spans``). Read
in the traced run, so it includes the profiler's cost on each operation.
None where the program records no span."""

from portbench.program_spans import self_us


def read(record):
    return self_us(record)
