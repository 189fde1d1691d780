"""PSANet-R50 (``configs/extra/psanet_r50_ade.py``): ResNetV1c-d8, PSAHead
and the FCN auxiliary head, narrow, against the JAX package on the CPU: the
checks of ``torch_port_extra_models`` (its docstring gives what each holds
and at what tolerance)."""

import pytest

import torch_port_extra_models as extra


@pytest.fixture(scope='module')
def case():
    return extra.make_case('psanet')


def test_feature_maps_and_logits(case):
    extra.check_feature_maps_and_logits(case)


def test_losses(case):
    extra.check_losses(case)


def test_step0_gradients_float64(case):
    extra.check_step0_gradients_float64(case)


def test_sgd_trajectory_float64(case):
    extra.check_sgd_trajectory_float64(case)


def test_the_jax_loader_reads_the_port_state_dict(case):
    extra.check_the_jax_loader_reads_the_port_state_dict(case)
