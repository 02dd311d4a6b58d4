"""Host milliseconds of split mode's pointwise VJP for each step: the
program's ``vjp`` spans (``adjoint.prestream_vjp``: the map's recompute
and its ``autograd.grad``, enqueued on the device) over its ``step``
spans, inside the window and outside the profiled stretch. The spans are
recorded in the traced run (``SPANS``); a program without the ``vjp``
span reads nothing."""

from torch_bench import trace

SPANS = True


def read(record):
    program = getattr(record, "program", None)
    if program is None:
        return None
    rows = [program.spans[i] for i in trace.window_spans(
        program.spans, program.window, program.stretch)]
    steps = sum(1 for name, _, _, _ in rows if name == "step")
    vjps = [end - start for name, _, start, end in rows if name == "vjp"]
    return 1e-6 * sum(vjps) / steps if steps and vjps else None
