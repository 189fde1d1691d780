"""APCHead, DMHead and ANNHead (``configs/_base_/models/apcnet_r50-d8.py``,
``dmnet_r50-d8.py``, ``ann_r50-d8.py``) on a narrow ResNetV1c-18-d8 with
the FCN auxiliary head, against the JAX package on the CPU: the checks of
``torch_port_attn_models`` (its docstring gives what each holds and at
what tolerance); per-module cases: DM at each filter size 1-7, and ANN's
refusal of a query scale other than 1. The 8 x 8 stride-8 map pools to
sizes that do not divide it (3 and 6), where the adaptive pools' bins
overlap."""

import pytest

import torch_port_attn_models as attn
from torch_port_attn_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module', params=['apcnet', 'dmnet', 'ann'])
def case(request):
    return attn.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    attn.run_check(check, case)


@pytest.mark.parametrize('filter_size', [1, 2, 3, 4, 5, 7])
def test_dcm_matches_jax(filter_size):
    attn.check_head_case(f'dm_s{filter_size}')


def test_ann_refuses_query_scales():
    attn.check_refusal('ann_query_scales')
