"""Million lattice updates a second of the gradient loop on a bounded
flow: every cell, every segment step, over the whole window of Adam
iterations (forward, loss, backward, Adam's step, loss.item()). Read in
the traced run, so the window holds the profiled stretch and the
backward span's synchronizes. A per-layer metric: the host binds this
cell, and its rate spreads too widely between runs to carry a bound."""

from torch_bench import trace


def read(record):
    if record.kind != "adam":
        return None
    return trace.window_mlups(record.cells, record.steps, record.window_s)
