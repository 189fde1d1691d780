"""EMAHead and EncHead (``configs/_base_/models/emanet_r50-d8.py``,
``encnet_r50-d8.py``) on a narrow ResNetV1c-18-d8 with the FCN auxiliary
head, against the JAX package on the CPU: the checks of
``torch_port_attn_models`` (its docstring gives what each holds and at
what tolerance; EMANet's bases buffer is held after each trajectory step,
EncNet's se logits and ``decode.loss_se`` with the rest); per-module
cases: EncNet with ``add_lateral``; and the JAX-side fault: under weight
decay the port leaves EMANet's frozen ``ema_mid_conv`` bitwise as it was
while the JAX optimizer decays it."""

import pytest

import torch_port_attn_models as attn
from torch_port_attn_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module', params=['emanet', 'encnet'])
def case(request):
    return attn.make_case(request.param)


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    attn.run_check(check, case)


def test_enc_head_with_laterals_matches_jax():
    attn.check_head_case('enc_add_lateral')


def test_frozen_conv_stays_put_under_weight_decay():
    attn.check_frozen_conv_under_weight_decay()
