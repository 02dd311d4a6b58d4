"""Percent of the program's kernels' roofline over the launches the
profiler recorded: the sum of each launch's bound (its family's bytes over
the HBM rate or its operations over the float32 rate, the larger) over the
sum of their device time."""


def read(record):
    if record.trace is None or record.trace.roofline is None:
        return None
    return 100 * record.trace.roofline
