"""The entropic KBC collision on the port, held against the benchmark's
plain reference (``torch_bench/reference/collisions/kbc.py``, written from
the paper's equations): one step of the port's torch step and of its
kernel path's plain versions, a split-mode gradient through
``make_segment_fn``, and the benchmark cell ``tgv3d_d3q27_kbc_128.grad8``
run small on the CPU, where its check passes the program and fails its
bfloat16 control and every planted fault. Also the cell's readers and
the kernel family of the ``none`` adjoint."""

import ast
import functools
import math
import warnings
from types import SimpleNamespace

import pytest
import torch

import lettuce_tpu_torch as ltt
from torch_bench import harness, trace
from torch_bench.faults import FAULTS
from torch_bench.flows import seeded_equilibrium
from torch_bench.reference import lbm
# the kernel path's plain wiring on the CPU, the route the cell takes on
# the card
from torch_bench.tests.conftest import kernel_path  # noqa: F401

CELL = "tgv3d_d3q27_kbc_128.grad8"
KBC = harness.collision_module(harness.HERE, "reference", "kbc")
SEED = 2 ** 31 + 17
# max |f - f_ref| / max |f_ref| of one step. float64: roundoff (3.3e-15
# measured). float32: at tau near 0.5 the step is close to 2 f_eq - f,
# and gamma is a ratio of two small entropic products, so the float32
# reference itself lies 1.1-2.9e-6 from float64 on these states and the
# port 1.8-2.8e-6 from it; 1e-5 leaves 3.5x room and is 1,000x under
# the 1 % noise
STEP_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def kbc_simulation(stencil, resolution, dtype):
    """A Re 1600 Taylor-Green vortex with the KBC collision at the units'
    relaxation time, on the torch step of a CPU context."""
    ctx = ltt.Context(device="cpu", dtype=dtype, use_native=False)
    flow = ltt.TaylorGreenVortex(ctx, resolution, 1600, 0.05,
                                 stencil=getattr(ltt, stencil)(),
                                 initialize_fneq=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU context's warning
        return ltt.Simulation(
            flow, ltt.KBCCollision(tau=flow.units.relaxation_parameter_lu),
            [])


def noisy_state(stencil, resolution, dtype, seed=SEED, noise=0.01):
    """The Taylor-Green field at density 1 and equilibrium, each population
    scaled by 1 + ``noise`` times a seeded normal deviate."""
    st = lbm.Stencil(stencil)
    u0 = 0.05 * math.sqrt(lbm.CS2)
    axes = [torch.arange(n, dtype=dtype) * (2 * math.pi / n)
            for n in resolution]
    grid = torch.meshgrid(*axes, indexing="ij")
    along_z = torch.cos(grid[2]) if st.d == 3 else 1
    u = [u0 * torch.sin(grid[0]) * torch.cos(grid[1]) * along_z,
         -u0 * torch.cos(grid[0]) * torch.sin(grid[1]) * along_z]
    if st.d == 3:
        u.append(torch.zeros_like(grid[0]))
    generator = torch.Generator().manual_seed(seed)
    return seeded_equilibrium({"init_noise": noise}, st,
                              torch.ones_like(grid[0]), torch.stack(u),
                              generator, None)


def reference_collide():
    return functools.partial(KBC.collide, params={})


CASES = [("D3Q27", [16, 16, 16]), ("D2Q9", [32, 32])]


@pytest.mark.parametrize("route", ["torch", "kernel"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("stencil,resolution", CASES,
                         ids=[c[0] for c in CASES])
def test_one_step_equals_the_reference(stencil, resolution, dtype, route):
    sim = kbc_simulation(stencil, resolution, dtype)
    if route == "kernel":
        sim._use_kernel()  # the wrappers' plain versions on the CPU
    assert sim.step_path == ("cuda x1" if route == "kernel" else "torch x1")
    f = noisy_state(stencil, resolution, dtype)
    st, tau = lbm.Stencil(stencil), sim.flow.units.relaxation_parameter_lu
    want = lbm.step(f, st, tau, collide=reference_collide())
    got = sim.make_step_fn()(f)
    assert got.dtype == dtype
    assert gap(got, want) < STEP_TOLERANCE[dtype]


@pytest.mark.parametrize("stencil,resolution",
                         [("D3Q27", [8, 8, 8]), ("D2Q9", [16, 16])],
                         ids=["D3Q27", "D2Q9"])
def test_split_mode_gradient_equals_autograd_through_the_reference(
        stencil, resolution):
    """Three steps through ``make_segment_fn`` on the kernel path's wiring
    (KBC's own adjoint, in full mode since it has one) against autograd
    through the reference's rollout, in float64: roundoff apart (about
    1e-15 measured), so 1e-10 allows the longer chain of sums."""
    sim = kbc_simulation(stencil, resolution, torch.float64)
    sim._use_kernel()
    assert sim.adjoint_mode == "full"
    f0 = noisy_state(stencil, resolution, torch.float64)
    cotangent = torch.randn(f0.shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(5))
    x = f0.clone().requires_grad_(True)
    (sim.make_segment_fn(3)(x) * cotangent).sum().backward()
    y = f0.clone().requires_grad_(True)
    st, tau = lbm.Stencil(stencil), sim.flow.units.relaxation_parameter_lu
    (lbm.run(y, 3, st, tau, checkpointed=True, collide=reference_collide())
     * cotangent).sum().backward()
    assert float(y.grad.abs().max()) > 0
    assert gap(x.grad, y.grad) < 1e-10


def test_the_vjps_tables_are_made_once():
    """Split mode's VJP recomputes the collision at every step. Its stencil
    tables and KBC's moment matrix are made on the state's device once and
    then shared: a copy from the host's memory at every step would wait
    for the device's stream. They hold what a fresh copy holds."""
    from lettuce_tpu_torch.ops import collision
    sim = kbc_simulation("D3Q27", [6, 6, 6], torch.float32)
    sim._use_kernel()
    x = noisy_state("D3Q27", [6, 6, 6], torch.float32).requires_grad_(True)
    sim.make_segment_fn(1)(x).sum().backward()
    before = collision._constant_table.cache_info()
    sim.make_segment_fn(2)(x).sum().backward()
    after = collision._constant_table.cache_info()
    assert after.misses == before.misses
    assert after.hits >= before.hits + 2 * 3  # e, w and M in each VJP
    e = sim.flow.stencil.e
    table = collision.constant_table(e, torch.float32, "cpu")
    assert table is collision.constant_table(e, torch.float32, "cpu")
    assert torch.equal(table, torch.as_tensor(e, dtype=torch.float32))
    w = collision.constant_table(sim.flow.stencil.w, torch.bfloat16, "cpu")
    assert torch.equal(w, torch.as_tensor(sim.flow.stencil.w,
                                          dtype=torch.bfloat16))


# The cell at 12^3, with the Reynolds number scaled with the grid (1600 x
# 12 / 128) so that it runs at the cell's tau, 0.5069. Its own limits
# are set at 128^3, where the loss, the gradient and Adam's change average
# over 2.1 M cells; at 12^3 the program's float32 gaps read larger (six
# seeds on the CPU: loss 3.4e-5-1.8e-4, gradient 1.7e-7-6.0e-6, change
# 5.8e-6-3.3e-4, state 2.2-3.2e-6), so this run is held to limits of its
# size, each about 10x or more above those readings and under the
# control's and the faults' (seed 2^31 + 17: bfloat16 1.10, 2.5e-2, 0.40,
# 9.2e-3; unchanged 1.0, 0.98, 0.14, 5.3e-3; half 0.53, 0.31, 0.27,
# 5.3e-3; altered 6.5e-4, 4.9e-5, 6.7e-4, 2.5e-3): state_gap fails each
SMALL = {"resolution": [12, 12, 12], "reynolds_number": 150}
SMALL_LIMITS = {"loss_gap": 2e-3, "grad_gap": 1e-4, "change_gap": 3e-3,
                "state_gap": 1e-4}


def small_cell(variant, monkeypatch):
    """One run of the cell at 12^3 (:data:`SMALL`, held to
    :data:`SMALL_LIMITS`) with ``variant``: the program, its bfloat16
    control or a fault of ``faults.py``; and what the run's program
    was."""
    load = harness.load_cell

    def small_limits(name, root=harness.ROOT):
        cell = load(name, root)
        assert set(cell.limits) == set(SMALL_LIMITS)
        cell.limits = dict(SMALL_LIMITS)
        return cell

    monkeypatch.setattr(harness, "load_cell", small_limits)
    seen = []
    fault = FAULTS.get(variant)

    def look(run):
        seen.append((run.sim.step_path, run.sim.adjoint_mode,
                     type(run.sim.collision).__name__))
        if fault is not None:
            fault(run)

    result = harness.run_cell(
        CELL, SEED, 0.2, False, device="cpu", config=SMALL,
        dtype="bfloat16" if variant == "bfloat16" else None, fault=look)
    return result, seen


def test_the_cell_is_correct_on_the_split_route(kernel_path, monkeypatch):
    result, seen = small_cell("program", monkeypatch)
    assert seen == [("cuda x1", "full", "KBCCollision")]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                     "state_gap", "finite"}
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("variant", ["bfloat16", *sorted(FAULTS)])
def test_the_cells_control_and_faults_fail(kernel_path, monkeypatch,
                                           variant):
    result, _ = small_cell(variant, monkeypatch)
    assert not result["correct"], result["checks"]


def test_the_reference_imports_no_jax_and_no_port():
    path = harness.HERE / "reference" / "collisions" / "kbc.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] in {"torch", "torch_bench"}, name


def test_the_cell_reads_its_metrics():
    cell = harness.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == [
        "grad_mlups", "peak_mem_gb", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "idle_share.grad", "kernel_roofline.grad", "backward_ms.grad",
        "vjp_host_ms.grad_kbc", "vjp_per_step.grad_kbc"]
    assert harness.asks_for_spans(cell)
    assert harness.collision_of(cell.config) == ("kbc", {})


def program_record(spans, counts, steps, stretch=None):
    return SimpleNamespace(program=SimpleNamespace(
        spans=spans, window=(0, 10 ** 9), stretch=stretch, counts=counts,
        steps=steps))


def test_vjp_readers():
    ms = 1_000_000
    spans = [("step", None, 0, ms), ("step", None, ms, 2 * ms),
             ("adjoint", None, 3 * ms, 9 * ms), ("vjp", 2, 4 * ms, 8 * ms),
             ("adjoint", None, 9 * ms, 14 * ms), ("vjp", 4, 10 * ms, 12 * ms),
             # inside the profiled stretch: left out
             ("step", None, 20 * ms, 21 * ms), ("vjp", None, 22 * ms, 30 * ms)]
    record = program_record(spans, {"vjp:kbc": 16, "K3:none_f32": 16}, 16,
                            stretch=(19 * ms, 31 * ms))
    assert harness.reader("vjp_host_ms.grad_kbc").read(record) == 3.0
    assert harness.reader("vjp_per_step.grad_kbc").read(record) == 1.0


def test_vjp_readers_find_nothing_without_the_programs_span_or_counter():
    """A program without the ``vjp`` span and counter, and a window that
    recorded nothing, read nothing and raise nothing."""
    ms = 1_000_000
    full = program_record([("step", None, 0, ms)], {"K3:none_f32": 8}, 8)
    empty = program_record([], {}, 0)
    for name in ("vjp_host_ms.grad_kbc", "vjp_per_step.grad_kbc"):
        read = harness.reader(name).read
        assert read(full) is None and read(empty) is None
        assert read(type("R", (), {"program": None})()) is None


NONE_ADJOINT = ("void lt::adjoint_kernel<lt::NoneAdjoint<lt::D3Q27, float>, "
                "lt::Same<float> >(float const*, float const*, float*, long, "
                "long, long, lt::NoneAdjoint<lt::D3Q27, float>::Params)")
BGK_ADJOINT = ("void lt::adjoint_kernel<lt::BgkAdjoint<lt::D3Q19, float>, "
               "lt::Same<float> >(float const*, float const*, float*, long, "
               "long, long, lt::BgkAdjoint<lt::D3Q19, float>::Params)")


def test_the_none_adjoint_has_a_family_of_its_own():
    """The ``none`` adjoint counts the 216 B of its cotangent at q = 27 and
    no saved velocity; the BGK adjoint keeps K3a's 164 B at q = 19."""
    families = harness.load_cell(CELL).families
    none = trace.family_of(NONE_ADJOINT, families)
    bgk = trace.family_of(BGK_ADJOINT, families)
    assert (none["name"], bgk["name"]) == ("K3_none", "K3a")
    q27 = {"q": 27, "d": 3, "s": 4, "c": 4, "m": 1}
    q19 = dict(q27, q=19)
    assert trace.bytes_per_update(none, q27) == 216
    assert trace.ops_per_update(none, q27) == 0
    assert trace.bytes_per_update(bgk, q19) == 164


KBC_ADJOINT = ("void lt::adjoint_kernel<lt::KbcAdjoint<lt::D3Q27, float>, "
               "lt::Same<float> >(float const*, float const*, float*, long, "
               "long, long, lt::KbcAdjoint<lt::D3Q27, float>::Params)")


def test_the_kbc_adjoint_has_a_family_of_its_own():
    """KBC's adjoint counts the 324 B of its cotangent, its saved step
    input and its output at q = 27, in its own family, not K3a's (whose
    pattern every adjoint_kernel instance matches) or the ``none``
    adjoint's; its operations stay under the bytes' time, so its share of
    the roofline cannot pass 100 %. BGK's adjoint keeps K3a's 164 B."""
    families = harness.load_cell(CELL).families
    kbc = trace.family_of(KBC_ADJOINT, families)
    bgk = trace.family_of(BGK_ADJOINT, families)
    none = trace.family_of(NONE_ADJOINT, families)
    assert (kbc["name"], bgk["name"], none["name"]) == ("K3_kbc", "K3a",
                                                        "K3_none")
    q27 = {"q": 27, "d": 3, "s": 4, "c": 4, "m": 1}
    assert trace.bytes_per_update(kbc, q27) == 324
    assert 0 < trace.ops_per_update(kbc, q27) <= 64 * 27
    peaks = {"kernel_prefix": "lt::", "hbm_bytes_per_s": 3.35e12,
             "fp32_ops_per_s": 67e12}
    cells = 128 ** 3
    share, unknown = trace.roofline_share(
        [(KBC_ADJOINT, 0.203e-3)], families, q27, cells, peaks)
    assert unknown == [] and 0.99 < share < 1.01  # the bytes' bound
    assert trace.bytes_per_update(bgk, dict(q27, q=19)) == 164
