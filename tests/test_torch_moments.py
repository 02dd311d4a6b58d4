"""The velocity moment of ``Flow.u`` and its adjoint (K5,
``lettuce_tpu_torch/ops/cuda/moments.py``) on the CPU: the Function's plain
version against the torch expression it replaces, ``gradcheck`` of its
closed-form adjoint, the 16-bit plain versions' single rounding, and the
route ``Flow.u`` takes on the card, driven here with the card faked (every
tensor reads ``is_cuda``, the library is a recording stub): which calls
launch K5, which keep the expression, the entries and arguments a launch
hands the library, and the counters. ``chip_smoke.py`` phase 37 runs the
kernels themselves against the plain versions on the card."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lettuce_tpu_torch as ltt
from lettuce_tpu_torch import tracing
from lettuce_tpu_torch.ops.cuda import build, moments

CSRC = Path(build.__file__).resolve().parents[2] / "csrc"
STENCILS = {"D1Q3": ((40,), ltt.D1Q3), "D2Q9": ((12, 10), ltt.D2Q9),
            "D3Q19": ((6, 5, 4), ltt.D3Q19), "D3Q27": ((4, 6, 5), ltt.D3Q27)}


def state(stencil, shape, dtype=torch.float64, seed=0):
    """A seeded positive state near rest: w_q (1 + 0.1 N(0, 1))."""
    rng = np.random.default_rng(seed)
    w = stencil.w.reshape((-1,) + (1,) * stencil.d)
    f = w * (1 + 0.1 * rng.standard_normal((stencil.q, *shape)))
    return torch.as_tensor(f, dtype=dtype)


def expression(f, e):
    """Flow.u's torch expression, j / rho."""
    et = torch.as_tensor(e, dtype=f.dtype)
    return torch.tensordot(et.T, f, dims=1) / torch.sum(f, dim=0,
                                                        keepdim=True)


# ----------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(STENCILS))
def test_plain_version_is_the_expression(name, dtype):
    """On a CPU state the Function runs today's expression: u bitwise,
    rho the sum over q."""
    shape, make = STENCILS[name]
    stencil = make()
    f = state(stencil, shape, dtype, seed=1)
    u, rho = moments.velocity_plain(f, stencil.e)
    assert u.dtype == dtype and tuple(u.shape) == (stencil.d, *shape)
    assert torch.equal(u, expression(f, stencil.e))
    assert torch.equal(rho, f.sum(dim=0, keepdim=True))
    assert torch.equal(moments.velocity(f, stencil.e), u)
    assert torch.equal(moments.velocity(f.requires_grad_(True), stencil.e),
                       u)


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_gradcheck_of_the_closed_form_adjoint(name):
    """The Function's backward, (e_q . g - u . g) / rho, is the exact VJP
    of u = j / rho (float64)."""
    shape, make = STENCILS[name]
    stencil = make()
    f = state(stencil, shape, seed=2).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: moments.velocity(x, stencil.e), (f,))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(STENCILS))
def test_adjoint_matches_autograd_of_the_expression(name, dtype, rtol):
    shape, make = STENCILS[name]
    stencil = make()
    f = state(stencil, shape, dtype, seed=3).requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (stencil.d, *shape)), dtype=dtype)
    got, = torch.autograd.grad(moments.velocity(f, stencil.e), f, g)
    want, = torch.autograd.grad(expression(f, stencil.e), f, g)
    assert got.dtype == dtype
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rtol * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["D2Q9", "D3Q19"])
def test_16_bit_plain_versions_compute_in_float32_and_round_once(name,
                                                                 dtype):
    """A 16-bit state: u is the float32 expression of the widened state
    rounded once, rho stays float32, and the cotangent is the float32
    closed form rounded once to the state's dtype (what K5 computes)."""
    shape, make = STENCILS[name]
    stencil = make()
    f = state(stencil, shape, torch.float32, seed=5).to(dtype)
    u, rho = moments.velocity_plain(f, stencil.e)
    wide = f.float()
    assert u.dtype == dtype and rho.dtype == torch.float32
    assert torch.equal(u, expression(wide, stencil.e).to(dtype))
    assert torch.equal(rho, wide.sum(dim=0, keepdim=True))
    g = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (stencil.d, *shape)), dtype=dtype)
    out = moments.velocity_adjoint_plain(g, u, rho, stencil.e)
    et = torch.as_tensor(stencil.e, dtype=torch.float32)
    want = ((torch.tensordot(et, g.float(), dims=1)
             - (u.float() * g.float()).sum(0, keepdim=True)) / rho)
    assert out.dtype == dtype and torch.equal(out, want.to(dtype))
    f.requires_grad_(True)
    got, = torch.autograd.grad(moments.velocity(f, stencil.e), f, g)
    assert torch.equal(got, out)


def test_no_grad_saves_nothing_and_keeps_no_graph():
    stencil = ltt.D2Q9()
    f = state(stencil, (8, 8), seed=7).requires_grad_(True)
    with torch.no_grad():
        u = moments.velocity(f, stencil.e)
    assert u.grad_fn is None and not u.requires_grad
    assert moments.velocity(f, stencil.e).grad_fn is not None


# ----------------------------------------------------------------------
# the C source's instances
# ----------------------------------------------------------------------
def test_compiled_instances_are_the_wrappers():
    """csrc/moments.cu compiles every stencil of moments.STENCILS in every
    storage of moments.STORAGE, stencils.cuh's tables equal the port's,
    and a 16-byte access holds the lanes the wrapper assumes."""
    text = (CSRC / "moments.cu").read_text()
    stencils = re.findall(r"^LT_VELOCITY_STENCIL\((\w+), (\w+)\)", text,
                          re.M)
    assert dict(stencils) == {name: cls.__name__
                              for name, cls in moments.STENCILS.items()}
    suffixes = re.findall(r"^ +LT_VELOCITY_ENTRIES\(STENCIL, S, (\w+), ",
                          text, re.M)
    assert sorted(suffixes) == sorted(moments.STORAGE.values())
    header = (CSRC / "stencils.cuh").read_text()
    for cls in moments.STENCILS.values():
        body = re.search(rf"struct {cls.__name__} {{.*?t\[Q\]\[D\] = "
                         rf"{{(.*?)}};", header, re.S).group(1)
        e = [int(x) for x in re.findall(r"-?\d+", body)]
        assert np.array_equal(np.reshape(e, cls.e.shape), cls.e)
    for dtype, lanes in moments._LANES.items():
        assert lanes * (torch.finfo(dtype).bits // 8) == 16
    assert "moments" in build.SOURCES


@pytest.mark.parametrize("name,expected", [
    *[(n, n.lower()) for n in STENCILS], ("D3Q15", "d3q15")])
def test_stencil_name(name, expected):
    stencil = getattr(ltt, name)()
    assert moments.stencil_name(stencil.e) == expected
    assert moments.stencil_name(stencil.e[::-1].copy()) is None


# ----------------------------------------------------------------------
# the route on the card, the card faked
# ----------------------------------------------------------------------
class Recorder:
    """A stand-in for the loaded library: every entry records its
    arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("lt_velocity"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class Stream:
    cuda_stream = 0


@pytest.fixture
def card(monkeypatch):
    """Every tensor reads as a CUDA tensor and K5's library records its
    launches; the counters start from zero."""
    lib = Recorder()
    moments._plan.cache_clear()
    monkeypatch.setattr(moments, "load_library", lambda: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True), raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(tracing, "counts", tracing.counts.__class__())
    yield lib
    monkeypatch.undo()
    moments._plan.cache_clear()


def tgv(dtype=torch.float32, resolution=(16, 16)):
    ctx = ltt.Context(device="cpu", dtype=dtype, use_native=False)
    # no f_neq: its initialisation would call Flow.u on the faked card
    return ltt.TaylorGreenVortex(ctx, list(resolution), 100, 0.05,
                                 stencil=ltt.D2Q9(), initialize_fneq=False)


def test_flow_u_on_the_card_launches_k5_and_its_adjoint(card):
    """A contiguous float32 state: one K5 launch, its entry handed the
    state, u, rho, the cells and 16-byte accesses; under autograd the
    backward is one adjoint launch; nothing counts as the expression."""
    flow = tgv()
    f = flow.f.clone().requires_grad_(True)
    u = flow.u(f)
    assert tuple(u.shape) == (2, 16, 16) and u.dtype == torch.float32
    ((entry, args),) = card.calls
    assert entry == "lt_velocity_d2q9_f32"
    assert args[0] == f.data_ptr() and args[1] == u.data_ptr()
    assert args[2] is not None and args[3:5] == (256, 1)
    u.sum().backward()
    entry, args = card.calls[1]
    assert entry == "lt_velocity_adjoint_d2q9_f32"
    assert args[2] == card.calls[0][1][2]  # the saved rho
    assert args[4:6] == (256, 1)
    assert f.grad is not None and f.grad.shape == f.shape
    assert dict(tracing.counts) == {"K5:u_f32": 1, "K5:adjoint_u_f32": 1}


@pytest.mark.parametrize("dtype,resolution,suffix,vectors", [
    (torch.float32, (15, 15), "f32", 0),     # 225 cells: one a thread
    (torch.bfloat16, (16, 16), "bf16", 1),
    (torch.bfloat16, (6, 10), "bf16", 0),    # 60 cells, lanes of 8
    (torch.float16, (8, 8), "f16", 1)])
def test_k5_launch_takes_16_byte_accesses_where_the_cells_allow(
        card, dtype, resolution, suffix, vectors):
    """No gradient: rho is not written (a null pointer) and nothing is
    saved; 16-byte accesses only when the lanes divide the cells."""
    flow = tgv(dtype, resolution)
    u = flow.u()
    ((entry, args),) = card.calls
    assert entry == f"lt_velocity_d2q9_{suffix}" and u.dtype == dtype
    assert args[2] is None and args[3] == int(np.prod(resolution))
    assert args[4] == vectors
    assert dict(tracing.counts) == {f"K5:u_{suffix}": 1}


def test_misaligned_state_takes_one_cell_a_thread(card):
    flow = tgv()
    buf = torch.empty(flow.f.numel() + 1)
    f = buf[1:].view(flow.f.shape)
    f.copy_(flow.f)
    flow.u(f)
    ((_, args),) = card.calls
    assert args[4] == 0


@pytest.mark.parametrize("route", ["rho", "acceleration", "view",
                                   "float64"])
def test_flow_u_keeps_the_expression(card, route):
    """A given rho, a forcing correction, a non-contiguous view and a
    float64 state keep j / rho on the card, with the expression's values
    and gradients, each counted as moments_torch."""
    flow = tgv(torch.float64 if route == "float64" else torch.float32)
    f = flow.f.clone().requires_grad_(True)

    def by_hand(x):
        rho = x.sum(dim=0, keepdim=True)
        et = torch.as_tensor(flow.stencil.e, dtype=x.dtype)
        u = torch.tensordot(et.T, x, dims=1) / rho
        if route == "acceleration":
            u = u + torch.tensor([1e-3, -2e-3],
                                 dtype=x.dtype).reshape(2, 1, 1) / (2 * rho)
        return u

    x = f.transpose(1, 2) if route == "view" else f
    kwargs = {"rho": x.sum(dim=0, keepdim=True)} if route == "rho" else {}
    if route == "acceleration":
        kwargs = {"acceleration": [1e-3, -2e-3]}
    got = flow.u(x, **kwargs)
    want = by_hand(x)
    assert torch.allclose(got, want, rtol=0, atol=0)
    g = torch.ones_like(got)
    a, = torch.autograd.grad(got, f, g)
    b, = torch.autograd.grad(want, f, g)
    assert torch.equal(a, b)
    assert card.calls == []
    assert dict(tracing.counts) == {"moments_torch": 1}


@pytest.mark.parametrize("dtype,launches", [(torch.float32, 1),
                                             (torch.float64, 0)])
def test_plain_collision_takes_u_where_flow_u_does(card, dtype, launches):
    """On the card the plain collision, which split mode's VJP
    differentiates, computes u as Flow.u and so the torch step do: one K5
    launch on a state K5 takes, the expression on any other."""
    from lettuce_tpu_torch.ops.cuda.stream_collide import collide_plain
    stencil = ltt.D2Q9()
    f = state(stencil, (8, 8), dtype)
    collide_plain(f, ("bgk", 1 / 0.8), stencil.e, stencil.w,
                  stencil.opposite, stencil.cs)
    assert [entry for entry, _ in card.calls] == \
        ["lt_velocity_d2q9_f32"] * launches
    assert dict(tracing.counts) == ({"K5:u_f32": 1} if launches else {})


@pytest.mark.parametrize("case", ["float64", "view", "q", "stencil", "cpu"])
def test_takes_refuses(card, monkeypatch, case):
    stencil = ltt.D2Q9()
    f = state(stencil, (8, 8), torch.float32)
    e = stencil.e
    if case == "float64":
        f = f.double()
    elif case == "view":
        f = f[:, :, ::2]
    elif case == "q":
        f = f[:5].contiguous()
    elif case == "stencil":
        e = e[::-1].copy()
    else:
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda self: False), raising=False)
    taken = moments.takes(state(stencil, (8, 8), torch.float32), stencil.e)
    assert taken == (None if case == "cpu" else "d2q9")
    assert moments.takes(f, e) is None


@pytest.mark.parametrize("case", ["float64", "view", "shape"])
def test_launch_raises_on_what_the_kernel_does_not_take(card, case):
    stencil = ltt.D3Q19()
    f = state(stencil, (4, 4, 4), torch.float32)
    if case == "float64":
        f = f.double()
    elif case == "view":
        f = f.transpose(1, 3)
    else:
        f = f[:, :, :, 0]
    with pytest.raises(ValueError):
        moments.velocity(f, stencil.e)
    assert card.calls == []


def test_entries_take_pointer_sized_arguments(monkeypatch):
    """load_library declares every entry: pointers as c_void_p (never a
    32-bit int), the cells as int64."""
    class Lib:
        def __init__(self):
            self.entries = {}

        def __getattr__(self, name):
            return self.entries.setdefault(name, type("Fn", (), {})())

    lib = Lib()
    monkeypatch.setattr(moments, "open_library", lambda name: lib)
    moments.load_library.cache_clear()
    try:
        moments.load_library()
    finally:
        moments.load_library.cache_clear()
    assert len(lib.entries) == 2 * len(moments.STENCILS) * len(
        moments.STORAGE)
    for name, fn in lib.entries.items():
        pointers = 4 if "adjoint" in name else 3
        assert fn.argtypes == [ctypes.c_void_p] * pointers + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
