#!/usr/bin/env python3
"""One traced run of a cell with lettuce_tpu_torch's own tracing on: the
per-layer readings of the program's spans and launch counters.

Run from the root of a checkout::

    python3 torch_bench/program_trace.py --workload obstacle2d_2048.grad8 \
        --seed <n> --seconds <s>

The run is ``run.py --trace 1``'s (``harness.run_cell``), inside
``lettuce_tpu_torch.tracing.recording()``, switched on before the program
is built. Its profiled stretch keeps the program's ``lt:`` labels beside
the harness's ``tb:`` spans, so the ``breakdown``'s idle gaps fall under
the innermost of either (an ``lt:`` label keeps its prefix). The readings
take the program's spans over the window outside the profiled stretch, so
the profiler's cost stays out, and its counters over the whole window:

* ``replay_ms``: replay span time per step;
* ``replay_ops``: device operations (kernels, copies, fills) whose runtime
  launch call ran inside an ``lt:replay`` label, per replay, in the
  profiled stretch;
* ``wrapper_us``: self time of ``launch`` (outside ``enqueue``) per launch;
* ``step_self_us``: self time of ``step`` (outside ``launch`` and
  ``replay``) per step;
* ``adjoint_us``: adjoint span time, its launch included, per step;
* ``launches_per_step``: kernel launches (``K1:`` .. ``K4:`` counts) per
  step over the window;
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
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "torch_bench" /
                                     "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_bench" /
                                         "torch_extensions")
sys.path.insert(0, str(ROOT))

KERNELS = ("K1:", "K2:", "K3:", "K4:")
# the categories of a profiler trace's host calls that launch device work
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


# ----------------------------------------------------------------------
# the readings, over a namespace ``program``: ``spans`` (the recorded
# (name, parent, start_ns, end_ns)), ``window`` and ``stretch`` ((start_ns,
# end_ns) of the measured window and of the profiled stretch, or None),
# ``counts`` (the counters' deltas over the window), ``steps`` (the window's
# steps) and ``replay_ops`` ((operations, replays) in the stretch, or None)
# ----------------------------------------------------------------------
def _tracing():
    from lettuce_tpu_torch import tracing
    return tracing


def window_spans(program) -> list:
    """``(name, duration_ns, self_ns)`` of each span inside the window and
    outside the profiled stretch."""
    lo, hi = program.window
    cut = program.stretch
    own = _tracing().self_times(program.spans)
    out = []
    for (name, _, start, end), self_ns in zip(program.spans, own):
        if start < lo or end > hi:
            continue
        if cut is not None and start < cut[1] and end > cut[0]:
            continue
        out.append((name, end - start, self_ns))
    return out


def _sums(program, name):
    """(calls, total ns, self ns) of ``name`` over :func:`window_spans`."""
    calls = total = own = 0
    for n, duration, self_ns in window_spans(program):
        if n == name:
            calls, total, own = calls + 1, total + duration, own + self_ns
    return calls, total, own


def replay_ms(program):
    steps = _sums(program, "step")[0]
    calls, total, _ = _sums(program, "replay")
    return 1e-6 * total / steps if steps and calls else None


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


def launches_per_step(program):
    launches = sum(n for key, n in program.counts.items()
                   if key.startswith(KERNELS))
    return launches / program.steps if program.steps else None


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


def _traced_profiled(harness, marks, record):
    """``harness.Profiled`` that marks the window and the stretch on the
    program's clock and reads the program's ``lt:`` labels too."""

    class Profiled(harness.Profiled):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            marks["window"] = [time.perf_counter_ns(), None]
            marks["counts"] = Counter(record.counts)

        def before(self, elapsed, seconds):
            idle = self.prof is None
            super().before(elapsed, seconds)
            if idle and self.prof is not None:
                marks["stretch"] = [time.perf_counter_ns(), None]

        def after(self):
            done = self.done
            super().after()
            if self.done and not done:
                marks["stretch"][1] = time.perf_counter_ns()

        def events(self):
            """``harness.Profiled.events``'s reading, the program's
            ``lt:`` labels (prefix kept) among the spans, from the one
            export a profiler session allows."""
            _close_window(marks, record)
            if self.prof is None:
                return None
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "trace.json"
                self.prof.export_chrome_trace(str(path))
                events = json.loads(path.read_text())["traceEvents"]
            marks["replay_ops"] = labelled_ops(events)
            device, spans, stretch = [], [], None
            for e in events:
                if e.get("ph") != "X":
                    continue
                name, category = e.get("name", ""), e.get("cat", "")
                start = float(e["ts"]) / 1e6
                end = start + float(e.get("dur", 0)) / 1e6
                if category in harness.DEVICE_CATEGORIES:
                    device.append((name, start, end))
                elif category != "user_annotation":
                    continue
                elif name == "tb:window":
                    stretch = (start, end)
                elif name.startswith("tb:"):
                    spans.append((name[3:], start, end))
                elif name.startswith("lt:"):
                    spans.append((name, start, end))
            return device, spans, stretch

    return Profiled


def _close_window(marks, record):
    """Mark the window's end and take the counters' deltas over it, once:
    at the profiled trace's reading, or after the run without one."""
    if marks["window"][1] is None:
        marks["window"][1] = time.perf_counter_ns()
        marks["counts"] = Counter(record.counts) - marks["counts"]


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
    marks = {"window": None, "stretch": None, "counts": Counter(),
             "replay_ops": None}
    real = harness.Profiled
    with tracing.recording() as record:
        harness.Profiled = _traced_profiled(harness, marks, record)
        try:
            result = harness.run_cell(workload, seed, seconds, trace,
                                      started=started, **cell)
        finally:
            harness.Profiled = real
        _close_window(marks, record)
    traffic = {**harness.load_cell(workload).traffic,
               **cell.get("traffic", {})}
    program = argparse.Namespace(
        spans=record.spans, window=tuple(marks["window"]),
        stretch=tuple(marks["stretch"]) if marks["stretch"] else None,
        counts=marks["counts"], replay_ops=marks["replay_ops"],
        steps=result["attempted"] * traffic.get("segment_steps", 0) or None)
    summary = {}
    for name, duration, own in window_spans(program):
        calls, total, self_ms = summary.get(name, (0, 0.0, 0.0))
        summary[name] = (calls + 1, total + 1e-6 * duration,
                         self_ms + 1e-6 * own)
    readings = {name: f(program) for name, f in READINGS.items()}
    result["program"] = {
        "readings": {k: v for k, v in readings.items() if v is not None},
        "spans": {k: list(v) for k, v in sorted(summary.items())},
        "counts": dict(sorted(marks["counts"].items())),
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
