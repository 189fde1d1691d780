"""FCN and OCRNet on HRNet (``configs/_base_/models/fcn_hr18.py``,
``ocrnet_hr18.py``: a cascade, FCN at weight 0.4 then OCR) and OCRNet on a
ResNetV1c-18-d8 (``ocrnet_r50-d8.py``), narrow, against the JAX package on
the CPU: the checks of ``torch_port_zoo_models`` (its docstring gives
what each holds and at what tolerance)."""

import pytest

import torch_port_zoo_models as zoo
from torch_port_zoo_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module',
                params=['fcn_hr', 'ocrnet_hr', 'ocrnet_r'])
def case(request):
    return zoo.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    getattr(zoo, f'check_{check}')(case)
