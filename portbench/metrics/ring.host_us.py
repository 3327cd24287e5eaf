"""ring.host_us: the device ring's host time a call: the spans ``ring.update``
(the new hop's ``cat`` into the ring, the spectrogram only) and
``ring.frames`` (the frames' copy into contiguous memory) directly under the
processor's span; mean over the traced window's calls, in microseconds
(``portbench.program_spans``). Read in the traced run, so it includes the
profiler's cost on each operation. None where the program records no span."""

from portbench.program_spans import mean_us


def read(record):
    return mean_us(record, ("ring.update", "ring.frames"))
