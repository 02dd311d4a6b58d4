"""The check that decides ``correct``, driven on the CPU at a size a test
run holds: the harness's whole run but the look for a card, the program
on its plain torch step (a blocked cell on the kernel path's plain
wrappers, which take its span). The program as the configuration states
it passes the cell's limits; its bfloat16 control fails them; and so does
each fault planted underneath the timed path."""

import ast
import sys
import types
from argparse import Namespace
from pathlib import Path

import pytest

from torch_bench import harness
from torch_bench.faults import FAULTS

HERE = Path(__file__).resolve().parents[1]
SMALL = {"tgv3d_d3q19_256": [16, 16, 16], "obstacle2d_2048": [64, 32]}
CELLS = ["tgv3d_d3q19_256.fwd", "tgv3d_d3q19_256.fwd_x2",
         "tgv3d_d3q19_256.grad8", "obstacle2d_2048.grad8"]


@pytest.fixture(autouse=True)
def blocked_on_the_kernel_path(request):
    """A cell whose traffic asks for a span runs on the kernel path's
    wiring, the only path that blocks; the others on the torch step."""
    cell = request.node.callspec.params.get("cell") if hasattr(
        request.node, "callspec") else None
    if cell and "n_sub" in harness.load_cell(cell).traffic:
        request.getfixturevalue("kernel_path")


def small_run(cell, seed=2 ** 31 + 7, **kwargs):
    config = cell.split(".")[0]
    return harness.run_cell(cell, seed, 0.2, False, device="cpu",
                            config={"resolution": SMALL[config]},
                            traffic={"steps_per_call": 5}, **kwargs)


def compared(result):
    return {k: c for k, c in result["checks"].items() if k != "finite"}


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_its_limits(cell):
    result = small_run(cell)
    assert compared(result), "no number compared"
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails(cell):
    result = small_run(cell, dtype="bfloat16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault):
    result = small_run(cell, fault=FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("outlet", ["pressure", "anti_bounce_back"])
def test_reference_outlets_follow_the_program(outlet):
    # the reference's two outlets against the program's at a small size;
    # anti-bounce-back is the witness of PERF.md's open question on it
    result = harness.run_cell(
        "obstacle2d_2048.grad8", 2 ** 31 + 9, 0.2, False, device="cpu",
        config={"resolution": [64, 32], "outlet": outlet})
    assert result["correct"], result["checks"]


def test_every_cell_has_limits():
    for cell in CELLS:
        limits = harness.load_cell(cell).limits
        assert limits and all(v > 0 for v in limits.values()), cell


def test_harness_imports_no_jax_click_or_lettuce_tpu():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in {
                    "jax", "click", "lettuce_tpu", "benchmarks", "bench"}, (
                        path, name)


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "card_lines", lambda chips: [])
    monkeypatch.setattr(harness, "process_age", lambda: 0.0)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    args = Namespace(workload="tgv3d_d3q19_256.fwd", seed=1, seconds=1,
                     trace=0)
    assert harness.forbidden_modules() == []
    assert harness.main(args) == 0
    assert capsys.readouterr().out.strip().endswith("}")
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "lettuce_tpu", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("z"))
    assert harness.forbidden_modules() == ["jax", "lettuce_tpu"]
    assert harness.main(args) == 1
    out, err = capsys.readouterr()
    assert out == "" and "jax, lettuce_tpu" in err
