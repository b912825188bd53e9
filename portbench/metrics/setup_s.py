"""setup_s: process start to the first timed call (import, CUDA set-up, the
weights drawn and quantized, every program of the cell captured)."""


def read(run):
    return run.setup_s
