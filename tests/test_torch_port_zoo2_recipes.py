"""This slice's recipes, datasets and module contracts against the JAX
package on the CPU: the three UNet recipes on HRF at full width (their
schedule, data and slide windows, and the port's state dict, which the
JAX loader places onto the JAX model's variables with nothing missing or
left over; the DRIVE recipes' data and windows), the four retinal vessel
datasets (classes, palette, suffixes, no zero-label reduction), a ResNeXt
bottleneck's width (the floor before the groups, against the JAX block's
shapes; at one group the reference's width, where the JAX package narrows
it: ROADMAP, known faults on the reference side), and ResNeSt's refusal of
non-default settings with the JAX message. The Cityscapes recipes
(``fast_scnn``, ``cgnet``, ``pspnet_s101-d8``) are held in
``test_torch_port_zoo_modules.py`` with the others."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu import datasets as jax_datasets
from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.models import build_backbone as build_jax_backbone
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.backbones.resnet import \
    Bottleneck as JaxBottleneck
from segdistill_tpu_torch import datasets
from segdistill_tpu_torch.models import build_backbone, build_segmentor
from segdistill_tpu_torch.models.backbones.resnet import Bottleneck
from segdistill_tpu_torch.recipes import (DRIVE_RECIPES, HRF_RECIPES,
                                         drive_recipe, hrf_recipe, recipe)

from torch_port_fixtures import NORM
from torch_port_zoo_models import one_thread  # noqa: F401

# recipe -> decode head
HRF_MODELS = {'fcn_unet_s5-d16': 'FCNHead', 'pspnet_unet_s5-d16': 'PSPHead',
              'deeplabv3_unet_s5-d16': 'ASPPHead'}
VESSELS = ['ChaseDB1Dataset', 'DRIVEDataset', 'HRFDataset', 'STAREDataset']


def test_the_hrf_recipes_are_listed():
    assert sorted(HRF_RECIPES) == sorted(HRF_MODELS)
    assert sorted(DRIVE_RECIPES) == [f'{n}_drive'
                                     for n in sorted(HRF_MODELS)]


@pytest.mark.parametrize('name', sorted(HRF_MODELS))
def test_hrf_recipe_builds_with_the_reference_layout(name):
    """mmseg's ``<name>_256x256_40k_hrf.py``: the fragment on HRF (256x256
    crops, batch 4, 2336x3504 requests), 40k SGD iterations, slide
    inference over 256x256 windows at stride 170; at full width the JAX
    loader takes every tensor of the port's state dict onto the JAX
    model's variables (``jax.eval_shape``) and leaves none missing."""
    cfg = hrf_recipe(name)
    assert cfg.optimizer == dict(type='SGD', lr=0.01, momentum=0.9,
                                 weight_decay=0.0005)
    assert cfg.runner['max_iters'] == 40000
    assert cfg.data['samples_per_gpu'] == 4
    assert cfg.crop_size == (256, 256)
    assert cfg.data['train']['dataset']['type'] == 'HRFDataset'
    assert cfg.data['test']['pipeline'][1]['img_scale'] == (2336, 3504)
    assert cfg.model['test_cfg'] == dict(mode='slide', crop_size=(256, 256),
                                         stride=(170, 170))
    model = build_segmentor(dict(cfg.model))
    assert type(model.backbone).__name__ == 'UNet'
    assert type(model.decode_head).__name__ == HRF_MODELS[name]
    assert model.num_classes == 2 and model.decode_head.in_index == 4
    assert model.auxiliary_head.in_index == 3
    jax_model = build_jax_segmentor(dict(cfg.model))
    shapes = jax.eval_shape(lambda: jax_model.net.init(
        {'params': jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        train=False, with_aux=True))
    variables = {c: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 shapes[c]) for c in ('params',
                                                      'batch_stats')}
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    _, matched, missing, unexpected = translate_state_dict(state, variables)
    assert unexpected == [] and missing == []
    assert len(matched) == sum(1 for k in state
                               if not k.endswith('num_batches_tracked'))


@pytest.mark.parametrize('name', sorted(HRF_MODELS))
def test_drive_recipe_is_the_hrf_model_on_drive(name):
    """mmseg's ``<name>_64x64_40k_drive.py``: the HRF recipe's model on
    DRIVE (64x64 crops, 584x565 requests), served with 64x64 windows at
    stride 42."""
    cfg, hrf = drive_recipe(f'{name}_drive'), hrf_recipe(name)
    assert cfg.data['test']['type'] == 'DRIVEDataset'
    assert cfg.data['test']['pipeline'][1]['img_scale'] == (584, 565)
    assert cfg.crop_size == (64, 64)
    assert cfg.runner['max_iters'] == 40000
    assert cfg.model['test_cfg'] == dict(mode='slide', crop_size=(64, 64),
                                         stride=(42, 42))
    assert {k: v for k, v in cfg.model.items() if k != 'test_cfg'} == \
        {k: v for k, v in hrf.model.items() if k != 'test_cfg'}
    assert recipe(f'{name}_drive').model == cfg.model


@pytest.mark.parametrize('name', VESSELS)
def test_vessel_dataset_matches_jax(name, tmp_path):
    (tmp_path / 'img').mkdir()
    got = datasets.DATASETS.get(name)(pipeline=[],
                                      img_dir=str(tmp_path / 'img'))
    want = jax_datasets.DATASETS.get(name)(pipeline=[],
                                           img_dir=str(tmp_path / 'img'))
    assert tuple(got.CLASSES) == tuple(want.CLASSES) == ('background',
                                                        'vessel')
    assert np.array_equal(np.asarray(got.PALETTE), np.asarray(want.PALETTE))
    for attr in ('img_suffix', 'seg_map_suffix', 'reduce_zero_label',
                 'ignore_index'):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert (got.img_suffix, got.seg_map_suffix) == ('.png', '.png')
    assert got.reduce_zero_label is False


def _jax_block_shapes(planes, groups, width_per_group, base_channels):
    block = JaxBottleneck(planes=planes, groups=groups,
                          width_per_group=width_per_group,
                          base_channels=base_channels, use_groups=True,
                          downsample=True, norm_cfg=dict(NORM))
    shapes = jax.eval_shape(lambda: block.init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 16))))
    return {k: shapes['params'][k]['kernel'].shape
            for k in ('conv1', 'conv2', 'conv3')}


@pytest.mark.parametrize('planes,groups,width_per_group,base_channels', [
    (24, 3, 5, 16), (64, 32, 4, 64), (16, 4, 4, 8)])
def test_resnext_width_floors_before_the_groups(planes, groups,
                                                width_per_group,
                                                base_channels):
    """width = planes * width_per_group // base_channels * groups (24 * 5
    // 16 = 7, times 3 = 21, where the product's floor would be 22), the
    3x3 conv in ``groups`` groups: the JAX block's kernel shapes."""
    width = planes * width_per_group // base_channels * groups
    block = Bottleneck(16, planes, groups=groups,
                       width_per_group=width_per_group,
                       base_channels=base_channels, norm_cfg=dict(NORM))
    want = _jax_block_shapes(planes, groups, width_per_group, base_channels)
    assert want['conv1'] == (1, 1, 16, width)
    assert tuple(block.conv1.weight.shape) == (width, 16, 1, 1)
    assert tuple(block.conv2.weight.shape) == (width, width // groups, 3, 3)
    assert block.conv2.groups == groups
    assert want['conv2'] == (3, 3, width // groups, width)
    assert tuple(block.conv3.weight.shape) == (4 * planes, width, 1, 1)


def test_resnext_of_one_group_keeps_the_reference_width():
    """The reference's ResNeXt bottleneck takes ``planes`` as its width at
    ``groups=1``; the JAX package applies the grouped formula anyway
    (planes * 4 // 64: a sixteenth). No config sets one group; the port
    follows the reference (ROADMAP, known faults on the reference side)."""
    cfg = dict(type='ResNeXt', depth=50, groups=1, base_width=4,
               num_stages=1, out_indices=(0,), norm_cfg=dict(NORM))
    port = build_backbone(dict(cfg))
    assert port.layer1[0].conv1.weight.shape[0] == 64
    jax_model = build_jax_backbone(dict(cfg))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    assert shapes['params']['layer1_0']['conv1']['kernel'].shape[-1] == 4


def test_resnet_groups_reach_every_bottleneck_and_refuse_basic_blocks():
    """``ResNet(groups=...)`` groups each bottleneck as ResNeXt does; a
    BasicBlock depth has no grouped conv and refuses the argument."""
    cfg = dict(depth=50, groups=4, width_per_group=4, num_stages=1,
               out_indices=(0,), norm_cfg=dict(NORM))
    net = build_backbone(dict(type='ResNet', **cfg))
    assert net.layer1[0].conv2.groups == 4
    assert net.layer1[0].conv1.weight.shape[0] == 64 * 4 // 64 * 4
    with pytest.raises(NotImplementedError, match='Bottleneck depth'):
        build_backbone(dict(type='ResNet', depth=18, groups=2))


@pytest.mark.parametrize('bad', [dict(radix=4), dict(reduction_factor=2),
                                 dict(avg_down_stride=False),
                                 dict(groups=2), dict(base_width=8)])
def test_resnest_refuses_what_jax_refuses(bad):
    for build in (build_backbone, build_jax_backbone):
        with pytest.raises(NotImplementedError) as err:
            build(dict(type='ResNeSt', depth=50, **bad))
        assert 'radix=2, reduction_factor=4, avg_down_stride=True' in \
            str(err.value)


def test_resnest_split_attention_softmax_over_the_radix():
    """Each channel's two radix weights sum to 1 (a softmax over axis 1 of
    (b, radix, C)): at equal splits the output is the split itself. The
    3x3 conv has groups * radix groups, so split r reads the r-th half of
    the input's channels: equal halves and equal weights make equal
    splits."""
    net = build_backbone(dict(type='ResNeSt', depth=50, stem_channels=16,
                              base_channels=8, num_stages=1,
                              out_indices=(0,), norm_cfg=dict(NORM)))
    net.init_weights(torch.Generator().manual_seed(0))
    sa = net.layer1[0].conv2
    with torch.no_grad():
        w = sa.conv.weight
        w[8:] = w[:8]  # both radix splits the same conv
        half = torch.randn(2, 4, 6, 6,
                           generator=torch.Generator().manual_seed(1))
        x = torch.cat([half, half], dim=1)
        sa.train()
        out = sa(x)
        split = torch.relu(sa.bn0(sa.conv(x)))[:, :8]
    assert torch.allclose(out, split, atol=1e-6)


def test_unet_norm_eval_keeps_its_norms_in_eval_mode():
    """``norm_eval``: every BN of the UNet stays in eval mode in training
    (the JAX UNet trains them as eval, ``train and not norm_eval``); the
    rest of the model trains."""
    for norm_eval in (False, True):
        net = build_backbone(dict(type='UNet', base_channels=4,
                                  num_stages=3, strides=(1, 1, 1),
                                  enc_num_convs=(1, 1, 1),
                                  dec_num_convs=(1, 1),
                                  downsamples=(True, True),
                                  enc_dilations=(1, 1, 1),
                                  dec_dilations=(1, 1), norm_cfg=dict(NORM),
                                  norm_eval=norm_eval)).train()
        norms = [m for m in net.modules()
                 if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        assert norms and all(m.training != norm_eval for m in norms)
        assert net.training
