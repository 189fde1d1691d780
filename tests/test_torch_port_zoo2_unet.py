"""UNet (``configs/_base_/models/*_unet_s5-d16.py``) under an FCN decode head and the FCN auxiliary head, 2 classes, base 8: the fragments' layout and a strided, unpooled, dilated one, against the JAX package on the CPU: the checks of
``torch_port_zoo2_models`` (its docstring gives what each holds and at
what tolerance)."""

import pytest

import torch_port_zoo2_models as zoo2
from torch_port_zoo2_models import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope='module', params=['unet', 'unet_strided'])
def case(request):
    return zoo2.make_case(request.param)


@pytest.mark.parametrize('check', zoo2.CHECKS)
def test_model_matches_jax(case, check):
    getattr(zoo2, f'check_{check}')(case)
