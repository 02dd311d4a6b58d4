"""lettuce_tpu_torch.cli on the CPU: the benchmark, and the TGV2D
convergence gate at (16, 32, 64) in float64, as tests/test_convergence.py
runs it for lettuce_tpu."""

import subprocess
import sys

import pytest
import torch

from lettuce_tpu_torch import cli


def test_benchmark_runs_torch_path(capsys):
    assert cli.main(["benchmark", "-r", "16", "-s", "5",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "MLUPS" in out
    assert "(torch x1 path)" in out
    assert "float64 on cpu" in out


def test_benchmark_options_before_subcommand(capsys):
    assert cli.main(["--device", "cpu", "-p", "single", "benchmark",
                     "-r", "8", "-s", "2", "-f", "taylor3d"]) == 0
    out = capsys.readouterr().out
    assert "float32 on cpu (torch x1 path)" in out


def test_convergence_gate_passes(capsys):
    assert cli.main(["convergence", "--max-resolution-exponent", "6",
                     "--device", "cpu"]) == 0
    rows = [line.split() for line in capsys.readouterr().out.splitlines()]
    assert [int(r[0]) for r in rows[1:]] == [16, 32, 64]
    order_u, order_p = float(rows[-1][2]), float(rows[-1][4])
    assert 1.9 < order_u < 2.1 and 0.9 < order_p < 1.1


def test_convergence_gate_fails_on_a_coarse_ladder(capsys):
    # two coarse grids are outside the asymptotic range: the gate says so
    assert cli.main(["convergence", "--max-resolution-exponent", "5",
                     "--device", "cpu", "-p", "single"]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_cuda_without_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the error path cannot be reached")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["benchmark", "-r", "8", "-s", "1"])
    with pytest.raises(SystemExit, match="device-id"):
        cli.main(["--device", "cpu", "-i", "0", "benchmark"])


def test_rejects_bad_choices():
    with pytest.raises(SystemExit) as err:
        cli.main(["--precision", "quadruple", "benchmark"])
    assert err.value.code == 2
    with pytest.raises(SystemExit) as err:
        cli.main(["benchmark", "-f", "cylinder2d", "--device", "cpu"])
    assert err.value.code == 2


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "lettuce_tpu_torch.cli",
                           "--help"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "benchmark" in proc.stdout and "convergence" in proc.stdout
