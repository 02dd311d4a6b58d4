"""lettuce_tpu_torch.UnitConversion: every converter and derived
characteristic matches lettuce_tpu on the same inputs."""

import numpy as np
import pytest
import torch

import lettuce_tpu as lt
import lettuce_tpu_torch as ltt

KWARGS = dict(reynolds_number=1600, mach_number=0.05,
              characteristic_length_pu=2 * np.pi,
              characteristic_length_lu=64,
              characteristic_velocity_pu=2.5,
              characteristic_density_pu=0.9)

CONVERTERS = sorted(name for name in dir(lt.UnitConversion)
                    if name.startswith("convert_"))
PROPERTIES = ["characteristic_velocity_lu", "characteristic_pressure_pu",
              "characteristic_pressure_lu", "viscosity_lu", "viscosity_pu",
              "relaxation_parameter_lu"]


def test_same_converters():
    assert CONVERTERS == sorted(name for name in dir(ltt.UnitConversion)
                                if name.startswith("convert_"))
    assert len(CONVERTERS) == 18


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_matches(name):
    jax_units = lt.UnitConversion(**KWARGS)
    torch_units = ltt.UnitConversion(**KWARGS)
    values = np.random.default_rng(7).uniform(0.5, 1.5, size=(2, 5))
    # python scalars
    assert getattr(torch_units, name)(1.357) == getattr(jax_units, name)(
        1.357)
    # a torch tensor against the same numpy input
    got = getattr(torch_units, name)(torch.as_tensor(values))
    want = getattr(jax_units, name)(values)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=0)


@pytest.mark.parametrize("name", PROPERTIES)
def test_characteristic_matches(name):
    assert (getattr(ltt.UnitConversion(**KWARGS), name)
            == getattr(lt.UnitConversion(**KWARGS), name))


def test_scale_factor_keeps_float32():
    units = ltt.UnitConversion(**KWARGS)
    x = torch.ones(3, dtype=torch.float32)
    assert units.convert_velocity_to_pu(x).dtype == torch.float32
    assert units.convert_density_lu_to_pressure_pu(x).dtype == torch.float32
