"""Million lattice updates a second over the whole window of a rollout:
every cell, every step, from the first call's start to the last call's
synchronize."""

from torch_bench import trace


def read(record):
    if record.kind != "rollout":
        return None
    return trace.window_mlups(record.cells, record.steps, record.window_s)
