"""Port parity end to end for densenet-121, on the CPU: the checks and
tolerances of ``test_torch_zoo_e2e_vgg.py``, in a file of its own so that
each file stays under a minute."""
import pytest

from test_torch_zoo_e2e_vgg import (check_chip_smoke_phase,
                                    check_own_h100_plan,
                                    check_reference_plan_and_weights)

MODELS = ["densenet-121"]


@pytest.mark.parametrize("model", MODELS)
def test_own_h100_plan_matches_reference(model):
    check_own_h100_plan(model)


@pytest.mark.parametrize("model", MODELS)
def test_reference_plan_and_weights_match_reference(model):
    check_reference_plan_and_weights(model)


@pytest.mark.parametrize("model", MODELS)
def test_chip_smoke_zoo_phase_runs_on_cpu(model):
    check_chip_smoke_phase(model)
