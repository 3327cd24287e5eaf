"""phase_values.host_us: the PHASE values' host time a call: the span
``phase.values`` (``kernels/spectrum.py::spectrum_values``' PHASE branch
after kernel A: the complex interpolation, the first-maximum argbin and the
cancellation, some sixty torch operations) directly under the processor's
span; mean over the traced window's calls, in microseconds
(``portbench.program_spans``). Read in the traced run, so it includes the
profiler's cost on each operation. None where the program records no
span."""

from portbench.program_spans import mean_us


def read(record):
    return mean_us(record, ("phase.values",))
