"""torch.cuda.max_memory_allocated() over the window (reset at its
start), in GB of 1e9 bytes."""


def read(record):
    return record.peak_bytes / 1e9 if record.peak_bytes else None
