"""Fixtures of the benchmark's CPU tests."""

import pytest


@pytest.fixture
def kernel_path(monkeypatch):
    """Simulations built inside the test select the kernel path on the
    CPU: the wrappers' plain versions, which step a blocked span too, and
    no library loaded. A blocked cell then takes its span on the CPU as it
    does on the card."""
    import lettuce_tpu_torch.simulation as simulation
    monkeypatch.setattr(simulation.Simulation, "_native_supported",
                        lambda self: True)
    monkeypatch.setattr(simulation, "load_libraries", lambda: None)
    monkeypatch.setattr(simulation.adjoint, "load_libraries", lambda: None)
