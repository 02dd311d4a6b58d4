"""Percent of the profiled stretch in which no operation ran on the
device: 1 - (union of device intervals) / (the stretch's wall time)."""


def read(record):
    if record.trace is None or record.trace.window_s <= 0:
        return None
    return 100 * (1 - record.trace.busy_s / record.trace.window_s)
