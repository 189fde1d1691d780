"""NLHead, GCHead, DNLHead and CCHead (``configs/_base_/models/
nonlocal_r50-d8.py``, ``gcnet_r50-d8.py``, ``dnl_r50-d8.py``,
``ccnet_r50-d8.py``) on a narrow ResNetV1c-18-d8 with the FCN auxiliary
head, against the JAX package on the CPU: the checks of
``torch_port_attn_models`` (its docstring gives what each holds and at
what tolerance); per-module cases: NL in 'dot_product' mode, GC with
average pooling and both fusions, CC on a 5 x 7 map, GC's LayerNorm eps
at context vectors of variance ~1e-3, and DNL's refusal of another mode."""

import pytest

import torch_port_attn_models as attn
from torch_port_attn_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module', params=['nonlocal', 'gcnet', 'dnl', 'ccnet'])
def case(request):
    return attn.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    attn.run_check(check, case)


@pytest.mark.parametrize('name', ['nl_dot_product', 'gc_avg_channel_mul',
                                  'cc_5x7'])
def test_head_matches_jax(name):
    attn.check_head_case(name)


def test_gc_layer_norm_eps_is_visible_at_small_spread():
    attn.check_gc_layer_norm_eps()


def test_dnl_refuses_another_mode():
    attn.check_refusal('dnl_mode')
