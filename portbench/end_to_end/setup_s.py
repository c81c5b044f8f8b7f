"""Seconds from the process's start to the window's start: CUDA start-up,
loading or building the kernels, making the data, sealing, warm-up."""


def read(record):
    return record["setup_s"]
