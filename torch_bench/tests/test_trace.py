"""The benchmark's arithmetic, on the CPU: the window rate, the union of
device intervals, idle gaps, rooflines over the launches the profiler
recorded, and each kernel family's bytes."""

import json
from pathlib import Path

import pytest

from torch_bench import trace as tr

HERE = Path(__file__).resolve().parents[1]
PEAKS = json.loads((HERE / "peaks.json").read_text())
FAMILIES = [json.loads(p.read_text())
            for p in sorted((HERE / "kernels").glob("*.json"))]
FAMILY = {f["name"]: f for f in FAMILIES}
K1A = ("void lt::stream_collide_kernel<lt::Bgk<lt::D3Q19, float>, "
       "lt::Same<float>, false, 1>(float const*, float*, float*, "
       "lt::CellGrid, lt::Bgk<lt::D3Q19, float>::Params)")
K1D = K1A.replace("false, 1>", "true, 1>")
K1B = ("void lt::masked_stream_collide_kernel<lt::Bgk<lt::D2Q9, float>, "
       "lt::Same<float>, false, 1>(float const*, float*)")


def test_window_rate():
    # 256^3 cells, 1,000 steps in 10 s
    assert tr.window_mlups(256 ** 3, 1000, 10.0) == pytest.approx(
        1677.7216)


def test_union_of_overlapping_launches_counts_once():
    intervals = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert tr.union(intervals) == [(0.0, 3.0), (5.0, 6.0)]
    assert tr.busy_seconds(intervals, 0.0, 10.0) == pytest.approx(4.0)
    # clipped to the stretch
    assert tr.busy_seconds(intervals, 1.5, 5.5) == pytest.approx(2.0)


def test_idle_gaps_and_their_labels():
    intervals = [(1.0, 2.0), (4.0, 5.0)]
    gaps = tr.idle_gaps(intervals, 0.0, 6.0)
    assert gaps == [(0.0, 1.0), (2.0, 4.0), (5.0, 6.0)]
    spans = [("call", 0.0, 6.0), ("replay", 2.0, 3.5)]
    labels = tr.label_gaps(gaps, spans)
    # each moment goes to the innermost span open then
    assert labels == {"call": pytest.approx(2.5),
                      "replay": pytest.approx(1.5)}
    assert tr.label_gaps([(7.0, 8.0)], spans) == {"other": 1.0}


@pytest.mark.parametrize("name,family", [
    (K1A, "K1a"), (K1D, "K1d"), (K1B, "K1b"),
    (K1B.replace("false, 1>", "true, 1>"), "K1b_emit_u"),
    ("void lt::adjoint_kernel<lt::BgkAdjoint<lt::D3Q19, float>, "
     "lt::Same<float> >(float const*)", "K3a"),
    ("void lt::masked_adjoint_kernel<lt::BgkAdjoint<lt::D2Q9, float>, "
     "lt::Same<float> >(float const*)", "K3c")])
def test_families_match_their_kernels(name, family):
    assert tr.family_of(name, FAMILIES)["name"] == family


@pytest.mark.parametrize("family,stencil,expected", [
    ("K1a", (19, 3), 152), ("K1d", (19, 3), 164), ("K3a", (19, 3), 164),
    ("K1b", (9, 2), 73), ("K1b_emit_u", (9, 2), 81), ("K3c", (9, 2), 81)])
def test_family_bytes_per_update(family, stencil, expected):
    # float32: 4-byte storage and compute, a one-byte boundary code
    q, d = stencil
    sizes = {"q": q, "d": d, "s": 4, "c": 4, "m": 1}
    assert tr.bytes_per_update(FAMILY[family], sizes) == expected


def test_roofline_over_recorded_launches_only():
    sizes = {"q": 19, "d": 3, "s": 4, "c": 4, "m": 1}
    cells = 256 ** 3
    bound = cells * 152 / PEAKS["hbm_bytes_per_s"]
    launches = [(K1A, bound / 0.8)] * 10
    share, unknown = tr.roofline_share(launches, FAMILIES, sizes, cells,
                                       PEAKS)
    assert share == pytest.approx(0.8) and unknown == []
    # records the profiler dropped change neither side of the ratio
    share, _ = tr.roofline_share(launches[:3], FAMILIES, sizes, cells,
                                 PEAKS)
    assert share == pytest.approx(0.8)
    # other kernels (the optimizer's) are not the program's
    share, _ = tr.roofline_share(
        launches + [("void at::native::elementwise_kernel<4>()", 1.0)],
        FAMILIES, sizes, cells, PEAKS)
    assert share == pytest.approx(0.8)
    assert tr.roofline_share([], FAMILIES, sizes, cells, PEAKS) == (None,
                                                                     [])


def test_unknown_program_kernel_gets_a_zero_bound():
    sizes = {"q": 19, "d": 3, "s": 4, "c": 4, "m": 1}
    cells = 256 ** 3
    bound = cells * 152 / PEAKS["hbm_bytes_per_s"]
    launches = [(K1A, bound), ("void lt::new_kernel<float>(float*)", bound)]
    share, unknown = tr.roofline_share(launches, FAMILIES, sizes, cells,
                                       PEAKS)
    assert share == pytest.approx(0.5)
    assert unknown == ["new_kernel"]


def test_template_name():
    assert tr.template_name(K1A) == "stream_collide_kernel"
    assert tr.template_name("void at::native::f<4>(int)") == "f"
    assert tr.template_name(
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<at::native::TensorListMetadata<4>, float>(int)") == (
            "multi_tensor_apply_kernel")
    assert tr.template_name(
        "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
        "float>(cublasGemvParams<float>)") == "kernel"
    assert tr.template_name("Kernel2") == "Kernel2"
    assert tr.template_name("Memcpy DtoH (Device -> Pinned)") == (
        "Memcpy DtoH (Device -> Pinned)")
