"""phase_decay_db.host_us: kernel G's wrapper, host time a call: the span
``kernel.phase_decay_db`` (``kernels/phase_decay_db.py``: its checks,
allocation and launch) directly under the processor's span; mean over the
traced window's calls, in microseconds (``portbench.program_spans``). Read
in the traced run, so it includes the profiler's cost on each operation.
None where the program records no span."""

from portbench.program_spans import mean_us


def read(record):
    return mean_us(record, ("kernel.phase_decay_db",))
