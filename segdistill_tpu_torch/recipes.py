"""Cityscapes training recipes composed from the repository's model
fragments, as mmseg's own Cityscapes configs compose them
(``configs/deeplabv3plus/deeplabv3plus_r50-d8_512x1024_40k_cityscapes.py``
and its siblings): ``_base_ = [models/<fragment>, datasets/cityscapes.py,
default_runtime.py, schedules/schedule_<n>k.py]`` plus the recipe's model
overrides. The config is built in memory (a temporary file that names the
four bases by absolute path): nothing is written under ``configs/``.

Each gives SGD at lr 0.01, momentum 0.9, weight decay 5e-4, the poly
schedule, 512x1024 crops and batch 2; the test pipeline serves 1024x2048
in whole mode. ``deeplabv3plus_m-v2-d8`` is mmseg's
``deeplabv3plus_m-v2-d8_512x1024_80k_cityscapes.py``: the DeepLabV3+
fragment on MobileNetV2 (dilated to stride 8), 80k iterations.
"""

from pathlib import Path

from .config import Config

BASE = Path(__file__).resolve().parents[1] / 'configs' / '_base_'

MNV2_D8 = dict(
    backbone=dict(_delete_=True, type='MobileNetV2', widen_factor=1.,
                  strides=(1, 2, 2, 1, 1, 1, 1),
                  dilations=(1, 1, 1, 2, 2, 4, 4), out_indices=(1, 2, 4, 6)),
    decode_head=dict(in_channels=320, c1_in_channels=24),
    auxiliary_head=dict(in_channels=96))

# name -> (model fragment, schedule, model overrides)
RECIPES = {
    'deeplabv3_r50-d8': ('deeplabv3_r50-d8', '40k', None),
    'deeplabv3plus_r50-d8': ('deeplabv3plus_r50-d8', '40k', None),
    'deeplabv3plus_m-v2-d8': ('deeplabv3plus_r50-d8', '80k', MNV2_D8),
    'fcn_hr18': ('fcn_hr18', '40k', None),
    'ocrnet_hr18': ('ocrnet_hr18', '40k', None),
    'ocrnet_r50-d8': ('ocrnet_r50-d8', '40k', None),
    'lraspp_m-v3-d8': ('lraspp_m-v3-d8', '40k', None),
}


def cityscapes_recipe(name):
    """-> the :class:`Config` of recipe ``name`` (a key of
    :data:`RECIPES`)."""
    fragment, schedule, model = RECIPES[name]
    bases = [BASE / 'models' / f'{fragment}.py',
             BASE / 'datasets' / 'cityscapes.py',
             BASE / 'default_runtime.py',
             BASE / 'schedules' / f'schedule_{schedule}.py']
    text = f'_base_ = {[str(b) for b in bases]!r}\n'
    if model is not None:
        text += f'model = {model!r}\n'
    return Config.fromstring(text)
