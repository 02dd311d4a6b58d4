"""Milliseconds of backward() for each segment step, with a synchronize
on each side, over the window's iterations outside the profiled
stretch."""


def read(record):
    calls = record.spans.get("backward")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls) / record.segment_steps
