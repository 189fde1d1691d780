"""ResNeXt-50 (4 groups of base width 4, an FCN head) and ResNeSt-50 (d8: PSPHead and the FCN auxiliary head, the ``pspnet_s101-d8`` recipe's layout), each narrow, against the JAX package on the CPU: the checks of
``torch_port_zoo2_models`` (its docstring gives what each holds and at
what tolerance)."""

import pytest

import torch_port_zoo2_models as zoo2
from torch_port_zoo2_models import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope='module', params=['resnext', 'resnest'])
def case(request):
    return zoo2.make_case(request.param)


@pytest.mark.parametrize('check', zoo2.CHECKS)
def test_model_matches_jax(case, check):
    getattr(zoo2, f'check_{check}')(case)
