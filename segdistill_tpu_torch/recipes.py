"""Training recipes composed from the repository's model fragments, as
mmseg's own configs compose them
(``configs/deeplabv3plus/deeplabv3plus_r50-d8_512x1024_40k_cityscapes.py``
and its siblings): ``_base_ = [models/<fragment>, datasets/<data>.py,
default_runtime.py, schedules/schedule_<n>k.py]`` plus the recipe's model
overrides. The config is built in memory (a temporary file that names the
four bases by absolute path): nothing is written under ``configs/``.

:data:`RECIPES` are on Cityscapes: SGD at lr 0.01, momentum 0.9, weight
decay 5e-4, the poly schedule, 512x1024 crops and batch 2; the test
pipeline serves 1024x2048 in whole mode. ``deeplabv3plus_m-v2-d8`` is
mmseg's ``deeplabv3plus_m-v2-d8_512x1024_80k_cityscapes.py``: the
DeepLabV3+ fragment on MobileNetV2 (dilated to stride 8), 80k iterations.
``pspnet_s101-d8`` is mmseg's ``pspnet_s101-d8_512x1024_80k_cityscapes.py``:
the PSPNet-R50-d8 fragment on ResNeSt-101 (a 128-channel deep stem, radix
2, reduction factor 4, the stride as a 3x3 average pool). ``fast_scnn``
and ``cgnet`` take the 80k schedule at batch 2 like the others, where
mmseg's own recipes differ: ``fast_scnn_4x8_80k_lr0.12_cityscapes.py``
trains batch 8 a GPU on 4 GPUs at lr 0.12 and weight decay 4e-5, and
``cgnet_512x1024_60k_cityscapes.py`` trains Adam at lr 0.001 for 60k
iterations at batch 8. The attention-head recipes
(:data:`ATTENTION_FRAGMENTS`: NL, GC, DNL, CC, ANN, APC, DM, DA, EMA and
Enc on ResNetV1c-50-d8, each with the FCN auxiliary head) are mmseg's
``<fragment>_512x1024_40k_cityscapes.py`` (``emanet_r50-d8``: ``80k``, its
only schedule) with the fragment as it stands.

:data:`HRF_RECIPES` are mmseg's ``{fcn,pspnet,deeplabv3}_unet_s5-d16_
256x256_40k_hrf.py``: the three UNet fragments (2 classes) on
``datasets/hrf.py`` (256x256 crops, batch 4, requests at 2336x3504) with
``schedule_40k.py``, served in slide mode with 256x256 windows at stride
170 (the recipes' tuple form of the fragments' ``crop_size`` 256 and
``stride`` 170). :data:`DRIVE_RECIPES` are mmseg's
``{fcn,pspnet,deeplabv3}_unet_s5-d16_64x64_40k_drive.py``: the same
fragments on ``datasets/drive.py`` (64x64 crops, requests at 584x565),
served with 64x64 windows at stride 42.

:data:`PASCAL_RECIPES` are PSPNet-R50-d8 (the fragment with the FCN
auxiliary head) on Pascal data: ``pspnet_r50-d8_voc12aug`` is mmseg's
``configs/pspnet/pspnet_r50-d8_512x512_20k_voc12aug.py`` (21 classes in
both heads, ``datasets/pascal_voc12_aug.py``: VOC 2012 with the SBD labels,
512x512 crops, batch 4; ``schedule_20k.py``), and
``pspnet_r50-d8_pascal_context`` mmseg's
``configs/pspnet/pspnet_r50-d8_480x480_40k_pascal_context.py`` (60 classes,
``datasets/pascal_context.py``: 480x480 crops, batch 4; ``schedule_40k.py``
with SGD at lr 0.004, momentum 0.9, weight decay 1e-4; served in slide
mode, 480x480 windows at stride 320).

:data:`MT_RECIPES` are multi-teacher CGD steps (:func:`mt_recipe`):
``configs/exp_tab5/segformer_CGD.py`` (MiT-B0 student, CGD with group size
10, alpha 3 and tau 2 on ``decode_head.linear_pred``, AdamW, poly warmup)
with an ``SDModuleMT`` of the teachers of
``configs/teacher_student_size/b2b0.py`` and ``b3b0.py``, MiT-B2 and
MiT-B3: ``mt_cgd_aligned`` has one CGD entry a teacher, ``mt_cgd_random``
one entry against both (the random ensemble). Their checkpoint paths are
cleared: the weights are random until checkpoints are given.
"""

from pathlib import Path

from .config import Config
from .zoo import distill_entry, segformer

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / 'configs' / '_base_'

MNV2_D8 = dict(
    backbone=dict(_delete_=True, type='MobileNetV2', widen_factor=1.,
                  strides=(1, 2, 2, 1, 1, 1, 1),
                  dilations=(1, 1, 1, 2, 2, 4, 4), out_indices=(1, 2, 4, 6)),
    decode_head=dict(in_channels=320, c1_in_channels=24),
    auxiliary_head=dict(in_channels=96))
RESNEST_S101 = dict(
    backbone=dict(type='ResNeSt', depth=101, stem_channels=128, radix=2,
                  reduction_factor=4, avg_down_stride=True))
HRF_SLIDE = dict(test_cfg=dict(mode='slide', crop_size=(256, 256),
                               stride=(170, 170)))
DRIVE_SLIDE = dict(test_cfg=dict(mode='slide', crop_size=(64, 64),
                                 stride=(42, 42)))
PSP_VOC12AUG = dict(decode_head=dict(num_classes=21),
                    auxiliary_head=dict(num_classes=21))
PSP_CONTEXT = dict(decode_head=dict(num_classes=60),
                   auxiliary_head=dict(num_classes=60),
                   test_cfg=dict(mode='slide', crop_size=(480, 480),
                                 stride=(320, 320)))
CONTEXT_SGD = dict(optimizer=dict(type='SGD', lr=0.004, momentum=0.9,
                                  weight_decay=0.0001))
UNET_FRAGMENTS = ('fcn_unet_s5-d16', 'pspnet_unet_s5-d16',
                  'deeplabv3_unet_s5-d16')

# name -> (model fragment, schedule, model overrides)
RECIPES = {
    'deeplabv3_r50-d8': ('deeplabv3_r50-d8', '40k', None),
    'deeplabv3plus_r50-d8': ('deeplabv3plus_r50-d8', '40k', None),
    'deeplabv3plus_m-v2-d8': ('deeplabv3plus_r50-d8', '80k', MNV2_D8),
    'fcn_hr18': ('fcn_hr18', '40k', None),
    'ocrnet_hr18': ('ocrnet_hr18', '40k', None),
    'ocrnet_r50-d8': ('ocrnet_r50-d8', '40k', None),
    'lraspp_m-v3-d8': ('lraspp_m-v3-d8', '40k', None),
    'fast_scnn': ('fast_scnn', '80k', None),
    'cgnet': ('cgnet', '80k', None),
    'pspnet_s101-d8': ('pspnet_r50-d8', '80k', RESNEST_S101),
}
# the attention heads on ResNetV1c-50-d8, each fragment as it stands, on
# mmseg's <fragment>_512x1024_40k_cityscapes.py schedule (EMANet's recipe
# is 80k only)
ATTENTION_FRAGMENTS = ('nonlocal_r50-d8', 'gcnet_r50-d8', 'dnl_r50-d8',
                       'ccnet_r50-d8', 'ann_r50-d8', 'apcnet_r50-d8',
                       'dmnet_r50-d8', 'danet_r50-d8', 'emanet_r50-d8',
                       'encnet_r50-d8')
RECIPES.update({f: (f, '80k' if f == 'emanet_r50-d8' else '40k', None)
                for f in ATTENTION_FRAGMENTS})
HRF_RECIPES = {f: (f, '40k', HRF_SLIDE) for f in UNET_FRAGMENTS}
DRIVE_RECIPES = {f'{f}_drive': (f, '40k', DRIVE_SLIDE)
                 for f in UNET_FRAGMENTS}
# name -> (model fragment, dataset, schedule, model overrides, top-level
# overrides)
PASCAL_RECIPES = {
    'pspnet_r50-d8_voc12aug': ('pspnet_r50-d8', 'pascal_voc12_aug', '20k',
                               PSP_VOC12AUG, None),
    'pspnet_r50-d8_pascal_context': ('pspnet_r50-d8', 'pascal_context',
                                     '40k', PSP_CONTEXT, CONTEXT_SGD),
}
MT_CONFIG = ROOT / 'configs' / 'exp_tab5' / 'segformer_CGD.py'
MT_TEACHERS = ('b2', 'b3')
# name -> distillation entries (one a teacher: aligned; one: the random
# ensemble)
MT_RECIPES = {
    'mt_cgd_aligned': len(MT_TEACHERS),
    'mt_cgd_random': 1,
}


def _compose(bases, model, overrides=None):
    """The config of ``bases`` with ``model`` and the top-level
    ``overrides`` merged over them, as a config file's own keys are."""
    text = f'_base_ = {[str(b) for b in bases]!r}\n'
    if model is not None:
        text += f'model = {model!r}\n'
    for key, value in (overrides or {}).items():
        text += f'{key} = {value!r}\n'
    return Config.fromstring(text)


def _fragment_recipe(fragment, dataset, schedule, model, overrides=None):
    return _compose([BASE / 'models' / f'{fragment}.py',
                     BASE / 'datasets' / f'{dataset}.py',
                     BASE / 'default_runtime.py',
                     BASE / 'schedules' / f'schedule_{schedule}.py'], model,
                    overrides)


def cityscapes_recipe(name):
    """-> the :class:`Config` of recipe ``name`` (a key of
    :data:`RECIPES`)."""
    fragment, schedule, model = RECIPES[name]
    return _fragment_recipe(fragment, 'cityscapes', schedule, model)


def hrf_recipe(name):
    """-> the :class:`Config` of recipe ``name`` (a key of
    :data:`HRF_RECIPES`)."""
    fragment, schedule, model = HRF_RECIPES[name]
    return _fragment_recipe(fragment, 'hrf', schedule, model)


def drive_recipe(name):
    """-> the :class:`Config` of recipe ``name`` (a key of
    :data:`DRIVE_RECIPES`)."""
    fragment, schedule, model = DRIVE_RECIPES[name]
    return _fragment_recipe(fragment, 'drive', schedule, model)


def pascal_recipe(name):
    """-> the :class:`Config` of recipe ``name`` (a key of
    :data:`PASCAL_RECIPES`)."""
    return _fragment_recipe(*PASCAL_RECIPES[name])


def mt_recipe(name):
    """-> the :class:`Config` of multi-teacher recipe ``name`` (a key of
    :data:`MT_RECIPES`), fp32; :func:`mt_bf16_options` makes it bf16."""
    cfg_s = segformer('b0')
    cfg_t = [segformer(v) for v in MT_TEACHERS]
    model = dict(_delete_=True, type='SDModuleMT', cfg_s=cfg_s, cfg_t=cfg_t,
                 distillation=[distill_entry('CGDLoss', {})
                               for _ in range(MT_RECIPES[name])],
                 s_pretrain=None, t_pretrain=None, train_cfg=dict(),
                 test_cfg=dict(mode='whole'))
    return _compose([MT_CONFIG], model)


def mt_bf16_options(config):
    """-> ``cfg_options`` that give an SDModuleMT config's student and every
    teacher bf16 backbones (a dotted key cannot reach the items of the
    ``cfg_t`` list, so the list is given whole)."""
    teachers = [dict(c, backbone=dict(c['backbone'], dtype='bfloat16'))
                for c in config.model['cfg_t']]
    return {'model.cfg_s.backbone.dtype': 'bfloat16', 'model.cfg_t': teachers}


ALL_RECIPES = (sorted(RECIPES) + sorted(HRF_RECIPES) + sorted(DRIVE_RECIPES)
               + sorted(PASCAL_RECIPES) + sorted(MT_RECIPES))


def recipe(name):
    """-> the :class:`Config` of any recipe of this module, by name."""
    if name in RECIPES:
        return cityscapes_recipe(name)
    if name in HRF_RECIPES:
        return hrf_recipe(name)
    if name in DRIVE_RECIPES:
        return drive_recipe(name)
    if name in PASCAL_RECIPES:
        return pascal_recipe(name)
    if name in MT_RECIPES:
        return mt_recipe(name)
    raise KeyError(f'unknown recipe {name!r}; known: {ALL_RECIPES}')
