"""Million lattice updates a second of the gradient loop: every cell,
every segment step, over the whole window of Adam iterations (forward,
loss, backward, Adam's step, loss.item())."""

from torch_bench import trace


def read(record):
    if record.kind != "adam":
        return None
    return trace.window_mlups(record.cells, record.steps, record.window_s)
