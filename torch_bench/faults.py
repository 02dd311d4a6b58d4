"""Faults planted underneath the timed path, each of which the check has
to catch: the program's step returning its state unchanged, advancing
only half of the grid, or altering one value of its answer. Each takes
the run (``harness.run_cell``'s ``fault``) after the program is built."""

from __future__ import annotations

import torch


def _half(out: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    h = out.shape[1] // 2
    return torch.cat([out[:, :h], f[:, h:]], dim=1)


def _altered(out: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    delta = torch.zeros_like(out)
    delta[(1,) + (0,) * (out.dim() - 1)] = 0.01
    return out + delta * out.detach()


def _plant(run, change):
    """Apply ``change(out, f)`` to every rollout call's result, or to every
    gradient segment's."""
    if run.cell.traffic["kind"] == "rollout":
        advance = run.sim._advance
        run.sim._advance = lambda f, n: change(advance(f, n), f)
    else:
        segment_fn = run.segment_fn

        def broken(sim, n):
            segment = segment_fn(sim, n)
            return lambda f: change(segment(f), f)

        run.segment_fn = broken


def unchanged(run):
    _plant(run, lambda out, f: f * 1)


def half(run):
    _plant(run, _half)


def altered(run):
    _plant(run, _altered)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
