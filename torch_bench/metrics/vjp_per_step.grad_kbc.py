"""Split mode's pointwise VJPs for each step of the window: the deltas of
the program's ``vjp:<fragment>`` counters (one a call of
``adjoint.prestream_vjp``) over the window's steps. It reads 1 while the
VJP runs as eager autograd; a program that counts no ``vjp:`` key reads
nothing."""


def read(record):
    program = getattr(record, "program", None)
    if program is None or not program.steps:
        return None
    calls = [n for key, n in program.counts.items()
             if key.startswith("vjp:")]
    return sum(calls) / program.steps if calls else None
