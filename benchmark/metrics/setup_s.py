"""Set-up seconds: process start to the first timed call (loading, drawing the
inputs and weights, building kernels, warm-up)."""


def read(record):
    return record.setup_s
