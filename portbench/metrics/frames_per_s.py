"""frames_per_s: stereo analysis frames (pairs x frames a call) completed
over the whole window, by the host's clock."""


def read(record):
    return record.frames / record.window_s if record.window_s > 0 else None
