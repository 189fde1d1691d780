"""Every Tab5 PSP and Swin config (``configs/exp_tab5/{psp,swin}_*.py``, 14
files) builds in the port at full width, and its student's state dict is
exactly the layout the JAX package reads: ``torch_loader.
translate_state_dict`` places every tensor of it, at its shape, onto the
JAX student's variables (``jax.eval_shape`` of its init: nothing is
computed), with no variable missing and no key left over. The student's
``decode_head.conv_seg`` is the tap the configs distil from, and the
teacher is the B3 SegFormer.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from segdistill_tpu.config import Config as JaxConfig
from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.models import build_segmentor

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for pat in ('psp_*.py', 'swin_*.py')
                 for p in glob.glob(os.path.join(ROOT, 'configs', 'exp_tab5',
                                                 pat)))
_JAX_SHAPES = {}


def _jax_student_shapes(name):
    """The JAX student's variable shapes, one abstract init per student
    family (the seven configs of a family share the student)."""
    family = name.split('_')[0]
    if family not in _JAX_SHAPES:
        cfg = JaxConfig.fromfile(os.path.join(ROOT, 'configs', 'exp_tab5',
                                              name))
        student = build_jax_segmentor(dict(cfg.model['cfg_s'],
                                           pretrained=None))
        img = jnp.zeros((1, 64, 64, 3), jnp.float32)
        shapes = jax.eval_shape(lambda: student.net.init(
            {'params': jax.random.key(0)}, img, train=False,
            with_aux=True))
        _JAX_SHAPES[family] = {col: shapes[col]
                               for col in ('params', 'batch_stats')}
    return _JAX_SHAPES[family]


def test_all_fourteen_are_listed():
    assert len(CONFIGS) == 14


@pytest.mark.parametrize('name', CONFIGS)
def test_config_builds_with_the_reference_layout(name):
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', 'exp_tab5', name))
    model = build_segmentor(dict(cfg.model))
    family = name.split('_')[0]
    backbone = type(model.student.backbone).__name__
    head = type(model.student.decode_head).__name__
    assert (backbone, head) == {'psp': ('ResNet', 'PSPHead'),
                                'swin': ('SwinTransformer',
                                         'UPerHead')}[family]
    assert type(model.teacher.backbone).__name__ == 'MixVisionTransformer'
    assert len(model.teacher.backbone.block3) == 18  # B3
    taps = {d['student_layer'] for d in model.distillation}
    assert taps <= {'decode_head.conv_seg'}
    assert (name.endswith('baseline.py')) == (not taps)
    state = {k: v.numpy() for k, v in model.student.state_dict().items()}
    _, matched, missing, unexpected = translate_state_dict(
        state, _jax_student_shapes(name))
    assert not missing, missing[:5]
    assert not unexpected, unexpected[:5]
    placed = {k for k in state if not k.endswith((
        'num_batches_tracked', 'relative_position_index'))}
    assert len(matched) == len(placed)
    if family == 'swin':
        # the last PatchMerging norm is over 4 x 384 channels
        norm = model.student.backbone.layers[2].downsample.norm
        assert norm.normalized_shape == (1536,)
        assert np.prod(model.student.backbone.layers[0].blocks[0].attn
                       .relative_position_index.shape) == 49 * 49
