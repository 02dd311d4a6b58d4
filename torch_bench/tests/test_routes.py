"""What the harness finds by name or takes from a cell's files, on the
CPU: collisions on both sides (BGK through the route computes what the
reference computed before it), lettuce's D3Q27 table, a new configuration
and collision added as new files only, the traffic's blocking span, and
the program's spans and counters for the per-layer readers."""

import json
import os
import shutil
from argparse import Namespace
from collections import Counter
from pathlib import Path

import pytest
import torch

import lettuce_tpu_torch as lt
from lettuce_tpu_torch import tracing
from torch_bench import harness
from torch_bench.reference import lbm

HERE = Path(__file__).resolve().parents[1]
BGK = harness.collision_module(HERE, "reference", "bgk")


def populations(st, shape, seed, dtype=torch.float32):
    """A seeded state near rest: w_q (1 + 0.05 N(0, 1))."""
    generator = torch.Generator().manual_seed(seed)
    w = torch.tensor(st.w, dtype=dtype).reshape((st.q,) + (1,) * st.d)
    noise = torch.randn((st.q, *shape), generator=generator, dtype=dtype)
    return w * (1 + 0.05 * noise)


# ----------------------------------------------------------------------
# collisions by name
# ----------------------------------------------------------------------
@pytest.mark.parametrize("collision,expected", [
    ("bgk", ("bgk", {})), ({"name": "bgk"}, ("bgk", {})),
    ({"name": "trt", "tau_minus": 0.75}, ("trt", {"tau_minus": 0.75}))])
def test_a_collision_is_a_name_or_an_object(collision, expected):
    assert harness.collision_of({"collision": collision}) == expected


@pytest.mark.parametrize("stencil,shape,channel", [
    ("D2Q9", (24, 12), True), ("D3Q19", (8, 6, 4), False)])
def test_bgk_through_the_route_is_bit_identical(stencil, shape, channel):
    st = lbm.Stencil(stencil)
    f = populations(st, shape, 11)
    tau = 0.6
    bounded = None
    if channel:
        solid = torch.zeros(shape, dtype=torch.bool)
        solid[8:11, 4:7] = True
        bounded = lbm.Channel(solid, [0.05, 0.0], "pressure")
    assert torch.equal(BGK.collide(f, st, tau, {}), lbm.bgk(f, st, tau))
    route = lambda g, s, t: BGK.collide(g, s, t, {})  # noqa: E731
    assert torch.equal(lbm.step(f, st, tau, bounded, route),
                       lbm.step(f, st, tau, bounded))
    assert torch.equal(lbm.run(f, 3, st, tau, bounded, collide=route),
                       lbm.run(f, 3, st, tau, bounded))


def test_the_programs_bgk_route_builds_the_flows_bgk():
    config = dict(json.loads(
        (HERE / "configs" / "tgv3d_d3q19_256.json").read_text()),
        resolution=[8, 8, 8])
    flow = harness._module(HERE / "flows" / "taylor_green.py", "tg_route")
    side = harness.collision_module(HERE, "flows", "bgk")
    sim = flow.program(lt, config, "cpu", torch.float32,
                       collision=lambda built: side.program(lt, built, {}))
    assert type(sim.collision) is lt.BGKCollision
    assert sim.collision.tau == sim.flow.units.relaxation_parameter_lu
    assert sim.collision.force is None


@pytest.mark.parametrize("side", ["flows", "reference"])
def test_a_missing_collision_module_stops_the_run(side):
    with pytest.raises(SystemExit, match=f"{side}/collisions/kbc.py"):
        harness.collision_module(HERE, side, "kbc")


def test_a_configuration_with_a_missing_collision_never_runs_bgk():
    with pytest.raises(SystemExit, match="flows/collisions/kbc.py"):
        harness.run_cell("tgv3d_d3q19_256.fwd", 5, 0.1, False, device="cpu",
                         config={"resolution": [8, 8, 8],
                                 "collision": {"name": "kbc"}})


# ----------------------------------------------------------------------
# D3Q27
# ----------------------------------------------------------------------
def test_d3q27_is_lettuces_table_in_the_ports_order():
    st, port = lbm.Stencil("D3Q27"), lt.D3Q27()
    assert st.e == [tuple(int(c) for c in v) for v in port.e]
    assert st.opposite == [int(i) for i in port.opposite]
    assert sum(st.w) == pytest.approx(1.0, abs=1e-15)
    assert sorted(st.w) == sorted([8 / 27] + [2 / 27] * 6 + [1 / 54] * 12
                                  + [1 / 216] * 8)
    for i, v in enumerate(st.e):
        assert st.e[st.opposite[i]] == tuple(-c for c in v)
    # second moments: sum w e_a e_b = cs^2 delta_ab
    for a in range(3):
        for b in range(3):
            m = sum(w * v[a] * v[b] for w, v in zip(st.w, st.e))
            assert m == pytest.approx(lbm.CS2 if a == b else 0.0,
                                      abs=1e-15)


def test_a_periodic_d3q27_bgk_step_conserves_mass_and_momentum():
    st = lbm.Stencil("D3Q27")
    f = populations(st, (6, 5, 4), 3, torch.float64)
    out = lbm.step(f, st, 0.55)
    assert out.sum().item() == pytest.approx(f.sum().item(), rel=1e-13)
    e = torch.tensor(st.e, dtype=torch.float64)
    for a in range(3):
        before = (e[:, a].reshape(-1, 1, 1, 1) * f).sum().item()
        after = (e[:, a].reshape(-1, 1, 1, 1) * out).sum().item()
        assert after == pytest.approx(before, abs=1e-12)


# ----------------------------------------------------------------------
# a configuration and a collision added as new files only
# ----------------------------------------------------------------------
NEW_COLLISIONS = {
    "none": ('''
def program(lt, flow, params):
    return lt.NoCollision()
''', '''
def collide(f, st, tau, params):
    return f
'''),
    "trt": ('''
def program(lt, flow, params):
    return lt.TRTCollision(tau=flow.units.relaxation_parameter_lu,
                           tau_minus=params["tau_minus"])
''', '''
from torch_bench.reference import lbm


def collide(f, st, tau, params):
    feq = lbm.equilibrium(f.sum(0), lbm.velocity(f, st), st)
    even = (f + f[st.opposite]) / 2 - (feq + feq[st.opposite]) / 2
    odd = (f - f[st.opposite]) / 2 - (feq - feq[st.opposite]) / 2
    return f - even / tau - odd / params["tau_minus"]
''')}


@pytest.mark.parametrize("collision", [{"name": "none"},
                                       {"name": "trt", "tau_minus": 0.8}])
def test_a_d3q27_configuration_added_as_new_files(tmp_path, collision):
    """A copy of the benchmark, a D3Q27 configuration with a collision the
    benchmark does not have, its two collision modules and its limits
    written as new files, and entries added to BENCHMARK.json: the cell
    runs through ``run_cell`` against the reference."""
    home = tmp_path / HERE.name
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    name = collision["name"]
    program, reference = NEW_COLLISIONS[name]
    (home / "flows" / "collisions" / f"{name}.py").write_text(program)
    (home / "reference" / "collisions" / f"{name}.py").write_text(reference)
    config = json.loads((HERE / "configs" / "tgv3d_d3q19_256.json")
                        .read_text())
    config.update(name="tgv3d_d3q27", stencil="D3Q27", collision=collision)
    (home / "configs" / "tgv3d_d3q27.json").write_text(json.dumps(config))
    (home / "limits" / "tgv3d_d3q27.fwd.json").write_text(
        json.dumps({"state_gap": 1e-4}))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tgv3d_d3q27", "source": "a test", "reduced": [],
        "file": f"{HERE.name}/configs/tgv3d_d3q27.json", "why": "a test"})
    spec["workloads"].append({
        "name": "tgv3d_d3q27.fwd", "config": "tgv3d_d3q27",
        "traffic": "fwd", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    seen = []

    def look(run):
        seen.append((type(run.sim.collision).__name__,
                     run.collide.func.__module__, run.collide.keywords))

    result = harness.run_cell(
        "tgv3d_d3q27.fwd", 2 ** 31 + 21, 0.1, False, device="cpu",
        root=tmp_path, config={"resolution": [8, 8, 8]},
        traffic={"steps_per_call": 3}, fault=look)
    assert result["correct"], result["checks"]
    params = {k: v for k, v in collision.items() if k != "name"}
    assert seen == [({"none": "NoCollision", "trt": "TRTCollision"}[name],
                     f"torch_bench_reference_collision_{name}",
                     {"params": params})]


# ----------------------------------------------------------------------
# the traffic's blocking span
# ----------------------------------------------------------------------
def small_x2(**kwargs):
    return harness.run_cell(
        "tgv3d_d3q19_256.fwd_x2", 2 ** 31 + 31, 0.1, False, device="cpu",
        config={"resolution": [8, 8, 8]}, traffic={"steps_per_call": 4},
        **kwargs)


@pytest.mark.parametrize("before", [None, "4"])
def test_the_span_is_set_while_the_program_is_built(kernel_path,
                                                    monkeypatch, before):
    import lettuce_tpu_torch.simulation as simulation
    if before is None:
        monkeypatch.delenv("LETTUCE_NSUB", raising=False)
    else:
        monkeypatch.setenv("LETTUCE_NSUB", before)
    seen = []
    build = simulation.build_fused_multi_step

    def spy(sim, *args, **kwargs):
        seen.append(os.environ.get("LETTUCE_NSUB"))
        return build(sim, *args, **kwargs)

    monkeypatch.setattr(simulation, "build_fused_multi_step", spy)
    result = small_x2()
    assert seen == ["2"]
    assert os.environ.get("LETTUCE_NSUB") == before
    assert result["correct"], result["checks"]


def test_a_refused_span_stops_the_run(monkeypatch):
    # on the CPU the torch step runs, which never blocks
    monkeypatch.delenv("LETTUCE_NSUB", raising=False)
    with pytest.raises(SystemExit, match=r"span 2 .*'torch x1'"):
        small_x2()
    assert "LETTUCE_NSUB" not in os.environ


def test_a_span_the_blocked_kernel_refuses_stops_the_run(kernel_path,
                                                         monkeypatch):
    import lettuce_tpu_torch.simulation as simulation
    monkeypatch.setattr(simulation, "build_fused_multi_step",
                        lambda sim, *args, **kwargs: None)
    with pytest.raises(SystemExit, match=r"span 2 .*'cuda x1'"):
        small_x2()


# ----------------------------------------------------------------------
# the program's spans and counters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cell,asks", [
    ("tgv3d_d3q19_256.fwd", False), ("tgv3d_d3q19_256.fwd_x2", False),
    ("tgv3d_d3q19_256.grad8", False), ("obstacle2d_2048.grad8", True)])
def test_only_cells_whose_readers_ask_record_spans(cell, asks):
    assert harness.asks_for_spans(harness.load_cell(cell)) is asks


def test_an_untraced_run_opens_nothing(monkeypatch):
    made = []

    class Window(harness.ProgramWindow):
        def __init__(self, enabled, spans):
            made.append((enabled, spans))
            super().__init__(enabled, spans)

    monkeypatch.setattr(harness, "ProgramWindow", Window)
    harness.run_cell("obstacle2d_2048.grad8", 2 ** 31 + 41, 0.1, False,
                     device="cpu", config={"resolution": [64, 32]})
    assert made == [(False, False)]


def test_the_window_records_spans_only_when_asked():
    def window(enabled, spans):
        w = harness.ProgramWindow(enabled, spans)
        w.open()
        recording = tracing._record is not None
        with tracing.span("replay"):
            tracing.count("K1:bgk_f32")
        w.close()
        return w.reading((1, 2), 4), recording

    reading, recording = window(True, True)
    assert recording and tracing._record is None
    assert [s[0] for s in reading.spans] == ["replay"]
    assert reading.counts == {"K1:bgk_f32": 1}
    assert reading.steps == 4 and reading.stretch == (1, 2)
    assert reading.window[0] <= reading.spans[0][2]
    reading, recording = window(True, False)
    assert not recording and reading.spans == []
    assert reading.counts == {"K1:bgk_f32": 1}
    reading, recording = window(False, True)
    assert not recording and reading is None


def fake_program(**kwargs):
    """A window [0, 100) ns: two steps, each with a replay of 10 and 20 ns,
    and a third in the profiled stretch [60, 100)."""
    base = dict(spans=[("step", None, 0, 30), ("replay", 0, 5, 15),
                       ("step", None, 30, 55), ("replay", 2, 31, 51),
                       ("step", None, 60, 90), ("replay", 4, 61, 89)],
                window=(0, 100), stretch=(60, 100),
                counts=Counter({"K1:masked_emit_u_bgk_f32": 24,
                                "K3:masked_bgk_f32": 24, "K5:u_f32": 51,
                                "K5:adjoint_u_f32": 51, "replay": 24,
                                "moments_torch": 2}),
                steps=24)
    base.update(kwargs)
    return Namespace(**base)


@pytest.mark.parametrize("metric,value", [
    ("replay_ms.grad_bounded", 1e-6 * 30 / 2),
    ("launches_per_step.grad_bounded", 150 / 24)])
def test_program_readers(metric, value):
    read = harness.reader(metric).read
    assert read(Namespace(program=fake_program())) == pytest.approx(value)
    assert read(Namespace(program=None)) is None
    assert read(Namespace()) is None


def test_readers_find_nothing_in_an_empty_window():
    empty = fake_program(spans=[], counts=Counter(), steps=0)
    for metric in ("replay_ms.grad_bounded",
                   "launches_per_step.grad_bounded"):
        assert harness.reader(metric).read(Namespace(program=empty)) is None
