"""Seconds from the harness's first line to the window's start: imports,
the kernels' build in a checkout's first run, the program's set-up, the
weights and batches, and the warm-up steps."""


def read(record):
    return record["setup_s"]
