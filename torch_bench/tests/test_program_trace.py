"""The readings of the program's own spans and counters
(``program_trace.py``) on synthetic records, the operations it puts under
an ``lt:replay`` label, idle gaps under nested ``lt:`` and ``tb:`` spans,
and one run on the CPU through the kernel path's wiring."""

import json
from argparse import Namespace
from collections import Counter
from pathlib import Path

import pytest

from torch_bench import harness
from torch_bench import program_trace as pt
from torch_bench import trace as tr

MS = 1_000_000  # ns


def program(**kwargs):
    """Two segment steps in a window [0, 100 ms), each a step (a launch
    with its enqueue, then a replay) and an adjoint (a launch with its
    enqueue) on autograd's thread; the profiled stretch [60, 100 ms)
    holds a third step, left out."""
    spans = [("load", None, -50 * MS, -40 * MS)]

    def step(t):
        i = len(spans)
        spans.extend([("step", None, t, t + 10 * MS),
                      ("launch", i, t + 1 * MS, t + 3 * MS),
                      ("enqueue", i + 1, t + 2 * MS, t + 2 * MS + MS // 2),
                      ("replay", i, t + 4 * MS, t + 8 * MS),
                      ("adjoint", None, t + 20 * MS, t + 25 * MS),
                      ("launch", i + 4, t + 21 * MS, t + 22 * MS),
                      ("enqueue", i + 5, t + 21 * MS,
                       t + 21 * MS + MS // 4)])

    for t in (0, 30 * MS, 60 * MS):
        step(t)
    base = dict(spans=spans, window=(0, 100 * MS), stretch=(60 * MS,
                                                            100 * MS),
                counts=Counter({"K1:masked_emit_u_bgk_f32": 3,
                                "K3:masked_bgk_f32": 3, "K5:u_f32": 3,
                                "replay": 3}),
                steps=3, replay_ops=(44, 2))
    base.update(kwargs)
    return Namespace(**base)


def test_window_spans_leave_out_the_stretch_and_the_set_up():
    names = Counter(name for name, _, _ in pt.window_spans(program()))
    assert names == {"step": 2, "launch": 4, "enqueue": 4, "replay": 2,
                     "adjoint": 2}


@pytest.mark.parametrize("reading,value", [
    ("replay_ms", 4.0),            # 4 ms a replay, one a step
    ("replay_ops", 22.0),          # 44 operations over 2 replays
    ("wrapper_us", (1500 + 750) / 2),  # launch less its enqueue
    ("step_self_us", 10_000 - 2000 - 4000),  # less launch and replay
    ("adjoint_us", 5000.0),        # its launch included
    ("launches_per_step", 3.0),    # K1, K3 and K5, not the replay counter
    ("load_s", 0.01)])
def test_readings(reading, value):
    assert pt.READINGS[reading](program()) == pytest.approx(value)


@pytest.mark.parametrize("reading", sorted(pt.READINGS))
def test_readings_find_nothing_in_an_empty_record(reading):
    empty = program(spans=[], counts=Counter(), steps=None, replay_ops=None)
    assert pt.READINGS[reading](empty) is None


def test_operations_under_a_replay_label():
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7, "tid": tid, "args": args}

    events = [
        x("user_annotation", "lt:replay", 100, 50),
        x("user_annotation", "lt:replay", 300, 50),
        x("user_annotation", "lt:step", 90, 400),
        # launched inside the first replay: a kernel, a copy, a fill
        x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=1),
        x("cuda_runtime", "cudaMemcpyAsync", 120, 2, correlation=2),
        x("cuda_runtime", "cudaMemsetAsync", 130, 2, correlation=3),
        # inside the second, on the driver API
        x("cuda_driver", "cuLaunchKernel", 310, 2, correlation=4),
        # outside any replay, or on another thread
        x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=5),
        x("cuda_runtime", "cudaLaunchKernel", 320, 2, tid=2,
          correlation=6),
        x("kernel", "elementwise_kernel", 400, 5, correlation=1),
        x("gpu_memcpy", "Memcpy DtoD", 410, 5, correlation=2),
        x("gpu_memset", "Memset", 420, 5, correlation=3),
        x("kernel", "lt::stream_collide_kernel", 430, 5, correlation=4),
        x("kernel", "elementwise_kernel", 440, 5, correlation=5),
        x("kernel", "elementwise_kernel", 450, 5, correlation=6)]
    assert pt.labelled_ops(events) == (4, 2)
    assert pt.labelled_ops(events, "lt:adjoint") == (0, 0)


def test_profiled_stretch_reads_program_labels_from_one_export():
    """The traced session's reading: the harness's device operations,
    ``tb:`` spans and stretch, the program's ``lt:`` labels with their
    prefix, and the operations under ``lt:replay``, from one export (a
    profiler session exports its trace once). The window and the
    counters are the harness's (``test_routes.py``)."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1, "args": args}

    events = [x("user_annotation", "tb:window", 0, 1000),
              x("user_annotation", "tb:segment", 10, 400),
              x("user_annotation", "lt:step", 20, 300),
              x("user_annotation", "lt:replay", 100, 100),
              x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=9),
              x("kernel", "elementwise_kernel", 500, 10, correlation=9),
              x("gpu_user_annotation", "lt:replay", 500, 10)]

    class Prof:
        exported = 0

        def export_chrome_trace(self, path):
            self.exported += 1
            assert self.exported == 1, "exported twice"
            Path(path).write_text(json.dumps({"traceEvents": events}))

    marks = {"replay_ops": None}
    profiled = pt._traced_profiled(harness, marks)(
        harness.Spans(False), 0.5, 2)
    profiled.prof = Prof()
    device, spans, stretch = profiled.events()
    assert device == [("elementwise_kernel", 500e-6, 510e-6)]
    assert stretch == (0.0, 1000e-6)
    assert [name for name, _, _ in spans] == ["segment", "lt:step",
                                              "lt:replay"]
    assert marks["replay_ops"] == (1, 1)


def test_idle_gaps_under_nested_program_and_harness_spans():
    # the harness's backward span holds the program's adjoint span (on
    # autograd's thread), which holds its launch; the segment span holds a
    # step and its replay
    spans = [("segment", 0.0, 4.0), ("lt:step", 0.5, 3.5),
             ("lt:replay", 1.0, 3.0), ("backward", 4.0, 10.0),
             ("lt:adjoint", 5.0, 9.0), ("lt:launch", 6.0, 7.0)]
    gaps = tr.idle_gaps([(2.0, 2.5), (7.5, 8.0)], 0.0, 10.0)
    labels = tr.label_gaps(gaps, spans)
    assert labels == {"segment": pytest.approx(1.0),
                      "lt:step": pytest.approx(1.0),
                      "lt:replay": pytest.approx(1.5),
                      "backward": pytest.approx(2.0),
                      "lt:adjoint": pytest.approx(2.5),
                      "lt:launch": pytest.approx(1.0)}
    assert sum(labels.values()) == pytest.approx(9.0)


def test_a_run_through_the_kernel_paths_wiring_on_the_cpu():
    """The obstacle gradient at 64x32 on the kernel path's wiring (the
    wrappers' plain versions): every step and its replay read, no kernel
    launched, the check still correct."""
    result = pt.run("obstacle2d_2048.grad8", 2 ** 31 + 77, 0.2, trace=False,
                    device="cpu", config={"resolution": [64, 32]},
                    fault=lambda run: run.sim._use_kernel())
    assert result["correct"], result["checks"]
    prog = result["program"]
    steps = 8 * result["attempted"]
    assert prog["counts"] == {"replay": steps}
    assert prog["spans"]["step"][0] == steps
    assert prog["spans"]["replay"][0] == steps
    assert prog["spans"]["adjoint"][0] == steps
    assert prog["readings"]["launches_per_step"] == 0
    assert {"replay_ms", "step_self_us", "adjoint_us"} <= set(
        prog["readings"])
    assert prog["span_cost_ns"]["on"] > 0
