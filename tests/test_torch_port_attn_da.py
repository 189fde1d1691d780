"""DAHead (``configs/_base_/models/danet_r50-d8.py``) on a narrow
ResNetV1c-18-d8 with the FCN auxiliary head, against the JAX package on
the CPU: the checks of ``torch_port_attn_models`` (its docstring gives
what each holds and at what tolerance), with all three logits (pam_cam,
pam, cam) and their three prefixed losses."""

import pytest

import torch_port_attn_models as attn
from torch_port_attn_models import one_thread  # noqa: F401 (autouse)

CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'sgd_trajectory_float64',
          'the_jax_loader_reads_the_port_state_dict']


@pytest.fixture(scope='module')
def case():
    return attn.make_case('danet')


@pytest.mark.parametrize('check', CHECKS)
def test_model_matches_jax(case, check):
    attn.run_check(check, case)


def test_losses_are_prefixed_by_branch(case):
    want = case['steps'][0]['log_vars']
    assert {k for k in want if k.startswith('decode.')} == {
        f'decode.{b}.{m}' for b in ('pam_cam', 'pam', 'cam')
        for m in ('loss_seg', 'acc_seg')}
