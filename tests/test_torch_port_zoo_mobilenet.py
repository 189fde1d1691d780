"""DeepLabV3+ on MobileNetV2-d8 (``configs/_base_/models/
deeplabv3plus_r50-d8.py`` with mmseg's ``deeplabv3plus_m-v2-d8``
overrides) and LRASPP on MobileNetV3 (``lraspp_m-v3-d8.py``, on the small
arch), narrow, against the JAX package on the CPU: the checks of
``torch_port_zoo_models`` (its docstring gives what each holds and at
what tolerance)."""

import pytest

import torch_port_zoo_models as zoo
from torch_port_zoo_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module',
                params=['deeplabv3plus_mnv2', 'lraspp_mnv3'])
def case(request):
    return zoo.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    getattr(zoo, f'check_{check}')(case)
