"""Host microseconds of each call the step loop makes into the forward
wrapper (ops/cuda/stream_collide.py stream_collide), no synchronize."""


def read(record):
    calls = record.spans.get("wrapper")
    return 1e6 * sum(calls) / len(calls) if calls else None
