"""setup_s: from the process's start to the first timed call: imports, the
CUDA context, the kernel library (built by nvcc only in a checkout's first
run), the audio made on the card, the program's set-up and the warm-up."""


def read(record):
    return record.setup_s
