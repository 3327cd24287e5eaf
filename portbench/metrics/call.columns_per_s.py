"""call.columns_per_s: spectrogram columns (one analysis frame each)
completed over the whole traced window, by the host's clock. The redraw is
paced by the host's enqueue, so the rate follows the host's speed from run
to run; read in the traced run, it includes the profiler's cost on each
operation."""


def read(record):
    return record.frames / record.window_s if record.window_s > 0 else None
