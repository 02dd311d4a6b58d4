"""The program's kernel launches for each step of the window: the deltas
of its launch counters ``K1:`` to ``K5:`` (the single-step and blocked
forwards, their adjoints, the velocity moment of ``Flow.u`` and its
adjoint) over the window's steps."""

KERNELS = ("K1:", "K2:", "K3:", "K4:", "K5:")


def read(record):
    program = getattr(record, "program", None)
    if program is None or not program.steps:
        return None
    launches = sum(n for key, n in program.counts.items()
                   if key.startswith(KERNELS))
    return launches / program.steps
