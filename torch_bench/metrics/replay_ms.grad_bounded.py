"""Milliseconds of the outlets' window replay for each step: the
program's ``replay`` spans over its ``step`` spans, inside the window and
outside the profiled stretch. The spans are recorded in the traced run
(``SPANS``)."""

from torch_bench import trace

SPANS = True


def read(record):
    program = getattr(record, "program", None)
    if program is None:
        return None
    rows = [program.spans[i] for i in trace.window_spans(
        program.spans, program.window, program.stretch)]
    steps = sum(1 for name, _, _, _ in rows if name == "step")
    replays = [end - start for name, _, start, end in rows
               if name == "replay"]
    return 1e-6 * sum(replays) / steps if steps and replays else None
