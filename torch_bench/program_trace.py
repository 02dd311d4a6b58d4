#!/usr/bin/env python3
"""One traced run of a cell with lettuce_tpu_torch's own tracing on: the
per-layer readings of the program's spans and launch counters.

Run from the root of a checkout::

    python3 torch_bench/program_trace.py --workload obstacle2d_2048.grad8 \
        --seed <n> --seconds <s>

The run is ``run.py --trace 1``'s (``harness.run_cell``), with the
harness's recording of the program's spans over the window
(``harness.ProgramWindow``) on for any cell, and the set-up inside a
``lettuce_tpu_torch.tracing.recording()`` of its own, switched on before
the program is built. The profiled stretch keeps the program's ``lt:``
labels beside the harness's ``tb:`` spans, as every traced run does, so
the ``breakdown``'s idle gaps fall under the innermost of either (an
``lt:`` label keeps its prefix). The readings take the program's spans
over the window outside the profiled stretch, so the profiler's cost
stays out, and its counters over the whole window. Where the benchmark
has a reader of the same quantity, the reading is that reader's, so the
tool and the benchmark never disagree:

* ``replay_ms``: replay span time per step
  (``metrics/replay_ms.grad_bounded.py``);
* ``replay_ops``: device operations (kernels, copies, fills) whose runtime
  launch call ran inside an ``lt:replay`` label, per replay, in the
  profiled stretch;
* ``wrapper_us``: self time of ``launch`` (outside ``enqueue``) per launch;
* ``step_self_us``: self time of ``step`` (outside ``launch`` and
  ``replay``) per step;
* ``adjoint_us``: adjoint span time, its launch included, per step;
* ``launches_per_step``: kernel launches (``K1:`` .. ``K5:`` counts) per
  step over the window (``metrics/launches_per_step.grad_bounded.py``);
* ``load_s``: seconds of the ``load`` spans (the libraries open once, in
  the set-up).

It prints the cell's result line with ``program`` added: those readings,
``{name: [calls, total_ms, self_ms]}`` of the spans it read, the window's
launch counts, and the cost of one span site off and on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "torch_bench" /
                                     "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_bench" /
                                         "torch_extensions")
sys.path.insert(0, str(ROOT))

# the categories of a profiler trace's host calls that launch device work
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


# ----------------------------------------------------------------------
# the readings, over a namespace ``program``: the harness's record of the
# program (``harness.ProgramWindow.reading``: ``spans``, the recorded
# (name, parent, start_ns, end_ns); ``window`` and ``stretch``, (start_ns,
# end_ns) of the measured window and of the profiled stretch, or None;
# ``counts``, the counters' deltas over the window; ``steps``, the window's
# steps) and ``replay_ops`` ((operations, replays) in the stretch, or None)
# ----------------------------------------------------------------------
def _tracing():
    from lettuce_tpu_torch import tracing
    return tracing


def window_spans(program) -> list:
    """``(name, duration_ns, self_ns)`` of each span inside the window and
    outside the profiled stretch."""
    from torch_bench import trace
    own = _tracing().self_times(program.spans)
    out = []
    for i in trace.window_spans(program.spans, program.window,
                                program.stretch):
        name, _, start, end = program.spans[i]
        out.append((name, end - start, own[i]))
    return out


def _sums(program, name):
    """(calls, total ns, self ns) of ``name`` over :func:`window_spans`."""
    calls = total = own = 0
    for n, duration, self_ns in window_spans(program):
        if n == name:
            calls, total, own = calls + 1, total + duration, own + self_ns
    return calls, total, own


def _benchmark_reading(metric):
    """The reading of the benchmark's reader of ``metric``."""
    def reading(program):
        from torch_bench import harness
        return harness.reader(metric).read(argparse.Namespace(
            program=program))
    reading.__name__ = metric.split(".")[0]
    return reading


replay_ms = _benchmark_reading("replay_ms.grad_bounded")
launches_per_step = _benchmark_reading("launches_per_step.grad_bounded")


def replay_ops(program):
    if not program.replay_ops or not program.replay_ops[1]:
        return None
    ops, replays = program.replay_ops
    return ops / replays


def wrapper_us(program):
    calls, _, own = _sums(program, "launch")
    return 1e-3 * own / calls if calls else None


def step_self_us(program):
    calls, _, own = _sums(program, "step")
    return 1e-3 * own / calls if calls else None


def adjoint_us(program):
    steps = _sums(program, "step")[0]
    calls, total, _ = _sums(program, "adjoint")
    return 1e-3 * total / steps if steps and calls else None


def load_s(program):
    total = sum(end - start for name, _, start, end in program.spans
                if name == "load")
    return 1e-9 * total if total else None


READINGS = {f.__name__: f for f in (replay_ms, replay_ops, wrapper_us,
                                    step_self_us, adjoint_us,
                                    launches_per_step, load_s)}


# ----------------------------------------------------------------------
# the profiled stretch's lt: labels and the operations launched in them
# ----------------------------------------------------------------------
def labelled_ops(events, label="lt:replay"):
    """``(operations, labels)``: the device operations of a profiler
    trace's ``events`` (kernels, copies, fills) whose runtime launch call,
    matched by correlation id, ran inside a ``label`` annotation on the
    same thread; and the number of such annotations."""
    from torch_bench.harness import DEVICE_CATEGORIES
    boxes = [(e.get("pid"), e.get("tid"), float(e["ts"]),
              float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == label]
    inside = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATEGORIES:
            continue
        t = float(e["ts"])
        if any(p == e.get("pid") and tid == e.get("tid") and s <= t <= f
               for p, tid, s, f in boxes):
            inside.add(e.get("args", {}).get("correlation"))
    inside.discard(None)
    ops = sum(1 for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATEGORIES
              and e.get("args", {}).get("correlation") in inside)
    return ops, len(boxes)


def _traced_profiled(harness, marks):
    """``harness.Profiled`` that also counts, from the one export a
    profiler session allows, the operations under ``lt:replay``
    (``marks["replay_ops"]``)."""

    class Profiled(harness.Profiled):
        def export(self):
            events = super().export()
            marks["replay_ops"] = labelled_ops(events)
            return events

    return Profiled


def _recorded_window(harness, marks):
    """``harness.ProgramWindow`` that records the program's spans in any
    run, traced or not, and keeps its reading (``marks["program"]``)."""

    class ProgramWindow(harness.ProgramWindow):
        def __init__(self, enabled, spans):
            super().__init__(True, True)

        def reading(self, stretch, steps):
            marks["program"] = super().reading(stretch, steps)
            return marks["program"]

    return ProgramWindow


def span_cost_ns(calls: int = 200_000) -> dict:
    """Host ns of one ``with tracing.span(...)`` site, off and on (on: in a
    recording, no profiler), less an empty loop's."""
    tracing = _tracing()

    def loop():
        span = tracing.span
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with span("step"):
                pass
        return (time.perf_counter_ns() - t0) / calls

    t0 = time.perf_counter_ns()
    for _ in range(calls):
        pass
    empty = (time.perf_counter_ns() - t0) / calls
    off = loop()
    with tracing.recording():
        on = loop()
    return {"off": off - empty, "on": on - empty}


def run(workload: str, seed: int, seconds: float, started: float = None,
        trace: bool = True, **cell) -> dict:
    """One run of ``workload`` with the program's tracing on (and the
    harness's profiled stretch with ``trace``): the result line with
    ``program`` added. ``cell`` goes to ``harness.run_cell`` (the CPU
    tests shrink the cell with it)."""
    from torch_bench import harness
    tracing = _tracing()
    cost = span_cost_ns()
    marks = {"replay_ops": None, "program": None}
    real = harness.Profiled, harness.ProgramWindow
    with tracing.recording() as setup:
        harness.Profiled = _traced_profiled(harness, marks)
        harness.ProgramWindow = _recorded_window(harness, marks)
        try:
            result = harness.run_cell(workload, seed, seconds, trace,
                                      started=started, **cell)
        finally:
            harness.Profiled, harness.ProgramWindow = real
    window = marks["program"]
    # the set-up's spans (the window's ran in the harness's recording),
    # then the window's, their parents shifted past the set-up's
    before = setup.spans
    spans = before + [(name, None if parent is None else parent + len(before),
                       start, end)
                      for name, parent, start, end in window.spans]
    program = argparse.Namespace(
        spans=spans, window=window.window, stretch=window.stretch,
        counts=window.counts, steps=window.steps,
        replay_ops=marks["replay_ops"])
    summary = {}
    for name, duration, own in window_spans(program):
        calls, total, self_ms = summary.get(name, (0, 0.0, 0.0))
        summary[name] = (calls + 1, total + 1e-6 * duration,
                         self_ms + 1e-6 * own)
    readings = {name: f(program) for name, f in READINGS.items()}
    result["program"] = {
        "readings": {k: v for k, v in readings.items() if v is not None},
        "spans": {k: list(v) for k, v in sorted(summary.items())},
        "counts": dict(sorted(window.counts.items())),
        "replay_ops": marks["replay_ops"], "span_cost_ns": cost}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    from torch_bench import harness
    started = time.perf_counter() - harness.process_age()
    for line in harness.card_lines(harness.load_cell(args.workload).chips):
        print(line)
    result = run(args.workload, args.seed, args.seconds, started)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
