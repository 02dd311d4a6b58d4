"""The port's host tracing (``lettuce_tpu_torch/tracing.py``) on the CPU:
off by default at one test per span site, the spans a traced gradient
segment records through the kernel path's wiring (its wrappers run their
plain versions on CPU tensors), their parents and self times, split
mode's ``vjp`` span and counter, the profiler's ``lt:`` labels, and the
uniform launch counter keys."""

import threading
import time
import warnings

import pytest
import torch

import lettuce_tpu_torch as ltt
from lettuce_tpu_torch import tracing


def port_kernel(flow):
    """A BGK simulation of ``flow`` on the kernel path's wiring."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        sim = ltt.Simulation(
            flow, ltt.BGKCollision(flow.units.relaxation_parameter_lu), [])
    sim._use_kernel()
    return sim


def channel():
    """A cylinder in a 64x32 D2Q9 channel with an equilibrium inlet and a
    pressure outlet, which the kernel path replays after each step."""
    class Channel(ltt.Obstacle):
        @property
        def boundaries(self):
            inlet, _, cylinder = ltt.Obstacle.boundaries.fget(self)
            return [inlet, ltt.EquilibriumOutletP([1, 0], self), cylinder]

    ctx = ltt.Context(device="cpu", dtype=torch.float64, use_native=False)
    flow = Channel(ctx, [64, 32], reynolds_number=80, mach_number=0.1,
                   domain_length_x=6.4)
    x, y = (g.cpu().numpy() for g in flow.grid)
    flow.mask = (x - 1.6) ** 2 + (y - 1.6) ** 2 < 0.3
    flow.initialize()
    sim = port_kernel(flow)
    assert sim.step_path == "cuda+hybrid x1"
    return sim


def taylor_green():
    ctx = ltt.Context(device="cpu", dtype=torch.float64, use_native=False)
    return port_kernel(ltt.TaylorGreenVortex(ctx, [16, 16], 100, 0.05,
                                             stencil=ltt.D2Q9()))


def loss_and_grad(sim, steps=4):
    """The loss (sum of squared velocities after ``steps`` steps) and its
    gradient with respect to the initial state."""
    f0 = sim.flow.f.clone().requires_grad_(True)
    loss = (sim.flow.view(sim.make_segment_fn(steps)(f0)).u() ** 2).sum()
    loss.backward()
    return loss.detach(), f0.grad


@pytest.fixture(params=["channel", "taylor_green"])
def sim(request):
    return {"channel": channel, "taylor_green": taylor_green}[
        request.param]()


def test_off_by_default_each_span_site_is_one_test(sim, monkeypatch):
    """Off, every span is the one shared null context: no clock is read,
    no profiler label opened, nothing recorded; the counters run on."""
    assert tracing._record is None
    assert tracing.span("step") is tracing.span("replay") is tracing._NULL

    def refuse(*args, **kwargs):
        raise AssertionError("a span read the clock or opened a label")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    replays = tracing.counts["replay"]
    loss_and_grad(sim)
    monkeypatch.undo()
    hybrid = sim.step_path == "cuda+hybrid x1"
    assert tracing.counts["replay"] - replays == (4 if hybrid else 0)
    with tracing.recording() as record:
        pass
    assert record.spans == [] and not record.counts
    assert tracing._record is None


def test_traced_segment_is_bitwise_the_untraced_one(sim):
    loss, grad = loss_and_grad(sim)
    with tracing.recording():
        traced_loss, traced_grad = loss_and_grad(sim)
    assert torch.equal(loss, traced_loss)
    assert torch.equal(grad, traced_grad)
    assert float(grad.abs().max()) > 0


def test_traced_segment_spans_and_self_times(sim):
    """Four ``step`` spans, each with one ``replay`` child on a flow with
    an outlet, four ``adjoint`` spans, every self time >= 0."""
    hybrid = sim.step_path == "cuda+hybrid x1"
    with tracing.recording() as record:
        loss_and_grad(sim)
    spans = record.spans
    names = [name for name, _, _, _ in spans]
    steps = [i for i, name in enumerate(names) if name == "step"]
    assert len(steps) == 4 and names.count("adjoint") == 4
    for i in steps:
        children = [name for name, parent, _, _ in spans if parent == i]
        assert children == (["replay"] if hybrid else [])
    assert names.count("replay") == (4 if hybrid else 0)
    assert record.counts["replay"] == (4 if hybrid else 0)
    for name, parent, start, end in spans:
        assert end >= start
        if parent is not None:
            assert parent < spans.index((name, parent, start, end))
            assert spans[parent][2] <= start and end <= spans[parent][3]
    own = tracing.self_times(spans)
    assert all(t >= 0 for t in own)
    summary = tracing.summary(spans)
    calls, total, self_ns = summary["step"]
    assert calls == 4 and 0 <= self_ns <= total
    if hybrid:
        assert self_ns == total - summary["replay"][1]


def split_taylor_green(stencil, resolution, dtype):
    """A Guo-forced BGK simulation, split mode on the kernel path's
    wiring."""
    ctx = ltt.Context(device="cpu", dtype=dtype, use_native=False)
    flow = ltt.TaylorGreenVortex(ctx, resolution, 1600, 0.05,
                                 stencil=getattr(ltt, stencil)())
    tau = flow.units.relaxation_parameter_lu
    accel = [1e-5] + [0.0] * (len(resolution) - 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        sim = ltt.Simulation(
            flow, ltt.BGKCollision(tau, force=ltt.Guo(flow, tau, accel)), [])
    sim._use_kernel()
    assert sim.adjoint_mode == "split"
    return sim


@pytest.mark.parametrize("stencil,resolution,dtype", [
    ("D2Q9", [16, 16], torch.float64), ("D3Q27", [6, 6, 6], torch.float64),
    ("D2Q9", [16, 16], torch.bfloat16)], ids=["D2Q9", "D3Q27", "D2Q9-bf16"])
def test_split_mode_backward_holds_one_vjp_span_a_step(stencil, resolution,
                                                       dtype):
    """Four steps' backward: four ``adjoint`` spans, each the parent of
    exactly one ``vjp`` span, and ``vjp:bgk_force`` counted once a step (a
    16-bit state's VJP on float32 copies counts once too)."""
    sim = split_taylor_green(stencil, resolution, dtype)
    before = tracing.counts["vjp:bgk_force"]
    with tracing.recording() as record:
        loss_and_grad(sim)
    spans = record.spans
    adjoints = [i for i, (name, _, _, _) in enumerate(spans)
                if name == "adjoint"]
    vjps = [(parent, start, end) for name, parent, start, end in spans
            if name == "vjp"]
    assert len(adjoints) == 4 and len(vjps) == 4
    assert sorted(parent for parent, _, _ in vjps) == adjoints
    for parent, start, end in vjps:
        assert spans[parent][2] <= start <= end <= spans[parent][3]
    assert record.counts["vjp:bgk_force"] == 4
    assert tracing.counts["vjp:bgk_force"] - before == 4
    assert not [k for k in record.counts if k.startswith("vjp:")
                and k != "vjp:bgk_force"]


def test_full_mode_backward_records_no_vjp(sim):
    assert sim.adjoint_mode == "full"
    with tracing.recording() as record:
        loss_and_grad(sim)
    assert "vjp" not in {name for name, _, _, _ in record.spans}
    assert not [k for k in record.counts if k.startswith("vjp:")]


def test_self_time_less_children():
    spans = [("step", None, 0, 100), ("launch", 0, 10, 40),
             ("enqueue", 1, 20, 30), ("replay", 0, 50, 90)]
    assert tracing.self_times(spans) == [30, 20, 10, 40]
    assert tracing.summary(spans)["launch"] == (1, 30, 20)


def test_span_on_another_thread_takes_no_parent_from_this_one():
    with tracing.recording() as record:
        with tracing.span("step"):
            worker = threading.Thread(target=lambda: tracing.span(
                "adjoint").__enter__().__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            with tracing.span("replay"):
                pass
    assert sorted((name, parent) for name, parent, _, _ in
                  record.spans) == [("adjoint", None), ("replay", 0),
                                    ("step", None)]


def test_spans_are_profiler_labels_while_it_runs():
    sim = channel()
    from torch.profiler import ProfilerActivity, profile
    with tracing.recording(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        loss_and_grad(sim, steps=1)
    labels = {e.name for e in prof.events() if e.name.startswith("lt:")}
    assert labels == {"lt:step", "lt:replay", "lt:adjoint"}


def test_nested_recording_resumes_the_outer_one():
    with tracing.recording() as outer:
        with tracing.span("step"):
            pass
        with tracing.recording() as inner:
            with tracing.span("replay"):
                pass
            tracing.count("replay")
        with tracing.span("adjoint"):
            pass
    assert [s[0] for s in outer.spans] == ["step", "adjoint"]
    assert [s[0] for s in inner.spans] == ["replay"]
    assert inner.counts == {"replay": 1} and not outer.counts


@pytest.mark.parametrize("kernel,variant,n_sub", [
    ("K1", "", None), ("K1", "masked_", None), ("K1", "emit_u_", None),
    ("K1", "masked_emit_u_", None), ("K2", "", 2), ("K2", "masked_", 4),
    ("K3", "", None), ("K3", "masked_", None), ("K3", "frozen_", None),
    ("K4", "", 2)])
@pytest.mark.parametrize("storage", ["f32", "f64", "bf16", "f16",
                                     "bf16_dev"])
def test_uniform_launch_key(kernel, variant, n_sub, storage):
    key = tracing.launch_key(kernel, variant, "bgk", storage, n_sub)
    span = "" if n_sub is None else f"_x{n_sub}"
    assert key == f"{kernel}:{variant}bgk_{storage}{span}"
    family, _, rest = key.partition(":")
    assert family == kernel and rest.startswith(variant + "bgk_")


@pytest.mark.parametrize("key,args", [
    ("K1:masked_emit_u_bgk_f32", ("K1", "masked_emit_u_", "bgk", "f32")),
    ("K1:trt_bf16_dev", ("K1", "", "trt", "bf16_dev")),
    ("K2:masked_bgk_f32_x2", ("K2", "masked_", "bgk", "f32", 2)),
    ("K3:masked_bgk_f32", ("K3", "masked_", "bgk", "f32")),
    ("K4:bgk_bf16_x2", ("K4", "", "bgk", "bf16", 2)),
    ("K5:u_f32", ("K5", "", "u", "f32")),
    ("K5:adjoint_u_bf16", ("K5", "adjoint_", "u", "bf16"))])
def test_launch_key_examples(key, args):
    assert tracing.launch_key(*args) == key


def test_counts_go_to_the_recording_too():
    before = tracing.counts["K1:bgk_f32"]
    with tracing.recording() as record:
        tracing.count("K1:bgk_f32", 3)
    tracing.count("K1:bgk_f32")
    assert tracing.counts["K1:bgk_f32"] - before == 4
    assert record.counts == {"K1:bgk_f32": 3}
