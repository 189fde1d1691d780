"""DeepLabV3 and DeepLabV3+ (``configs/_base_/models/deeplabv3_r50-d8.py``,
``deeplabv3plus_r50-d8.py``) on a narrow ResNetV1c-18-d8, each with the
FCN auxiliary head, against the JAX package on the CPU: the checks of
``torch_port_zoo_models`` (its docstring gives what each holds and at
what tolerance). DeepLabV3+ on MobileNetV2 is in
``test_torch_port_zoo_mobilenet.py``."""

import pytest

import torch_port_zoo_models as zoo
from torch_port_zoo_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module',
                params=['deeplabv3', 'deeplabv3plus'])
def case(request):
    return zoo.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    getattr(zoo, f'check_{check}')(case)
