"""Seconds from the process's start to the window's start: import, build
or load of the kernels, the seeded inputs, the warm-up."""


def read(record):
    return record.setup_s
