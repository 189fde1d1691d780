"""JAX variables -> this package's state dict, for the MiT, ResNet and
Swin backbones, the FPN neck and the SegFormer, PSP, UPer, FCN, PSA, FPN
and point heads.

The inverse of ``segdistill_tpu/convert/torch_loader.py``'s rules: conv
kernels HWIO -> OIHW, Dense kernels (I, O) -> (O, I), norm ``scale`` ->
``weight``, ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
``running_var``; Flax list names ``block1_0`` -> ``block1.0``,
``layer1_0`` -> ``layer1.0``, ``layers_0_blocks_1`` ->
``layers.0.blocks.1``, ``lateral_convs_0`` -> ``lateral_convs.0`` (also
``fpn_convs``, ``convs``, ``fcs``, ``attention[_p]``,
``decode_heads_1`` -> ``decode_head.1``, ``auxiliary_head_0``); the
NormLayer nesting ``bn1.bn`` -> ``bn1`` (a ConvModule's ``bn.bn`` ->
``bn``); the reference's Sequential slots: the deep stem
``stem_conv{1,2,3}``/``stem_bn{1,2,3}`` -> ``stem.{0,3,6}``/``stem.{1,4,7}``,
a shortcut's ``downsample.conv``/``downsample.bn`` -> ``downsample.0``/
``.1`` (``.1``/``.2`` behind the average pool of ``avg_down``, where the
target ``keys`` say so), a pyramid branch ``psp_modules.pool_0`` ->
``psp_modules.0.1``, an FPNHead conv ``scale_heads_1_1`` ->
``scale_heads.1.2`` (behind the upsample slots); the point head's 1x1
convs (``fcs.*``) and ``fc_seg`` -> Conv1d weights (O, I, 1); the head's
Dense params ``linear_c4`` -> ``linear_c4.proj``, UPer's
``psp_bottleneck`` -> ``bottleneck``, Swin's ``patch_embed_proj`` ->
``patch_embed.proj``. Swin's bias tables keep their
name, and each gets the ``relative_position_index`` buffer the reference
``.pth`` carries. Takes the ``{'params', 'batch_stats'}`` tree as numpy
arrays (or anything ``np.asarray`` reads), or an SDModule's ``{'student',
'teacher'}`` pair of such trees, whose student params may hold the
``distill_adapters`` (kernel (c_s, c_t) -> weight (c_t, c_s)); float64
arrays stay float64, everything else becomes float32; imports no JAX.
"""

import math
import re
from collections.abc import Mapping

import numpy as np
import torch

_STEM = {'conv1': 'stem.0', 'bn1': 'stem.1', 'conv2': 'stem.3',
         'bn2': 'stem.4', 'conv3': 'stem.6', 'bn3': 'stem.7'}
_MODULE_RULES = [
    (re.compile(r'\bblock(\d+)_(\d+)\b'), r'block\1.\2'),
    (re.compile(r'\blayer(\d+)_(\d+)\b'), r'layer\1.\2'),
    (re.compile(r'\blayers_(\d+)_blocks_(\d+)\b'), r'layers.\1.blocks.\2'),
    (re.compile(r'\blayers_(\d+)_downsample\b'), r'layers.\1.downsample'),
    (re.compile(r'\bpatch_embed_(proj|norm)\b'), r'patch_embed.\1'),
    (re.compile(r'\b(lateral_convs|fpn_convs|convs|fcs)_(\d+)\b'),
     r'\1.\2'),
    (re.compile(r'\battention(_p)?_(\d)\b'), r'attention\1.\2'),
    (re.compile(r'\bscale_heads_(\d+)_(\d+)\b'),
     lambda m: f'scale_heads.{m.group(1)}.{2 * int(m.group(2))}'),
    (re.compile(r'\bdecode_heads_(\d+)\b'), r'decode_head.\1'),
    (re.compile(r'\bauxiliary_head_(\d+)\b'), r'auxiliary_head.\1'),
    (re.compile(r'\bpsp_modules\.pool_(\d+)\b'), r'psp_modules.\1.1'),
    (re.compile(r'\bpsp_bottleneck\b'), 'bottleneck'),
    (re.compile(r'\blinear_c(\d)$'), r'linear_c\1.proj'),
    (re.compile(r'\bstem_(conv\d|bn\d)(\.bn)?$'),
     lambda m: _STEM[m.group(1)]),
    (re.compile(r'\bdownsample\.conv$'), 'downsample.0'),
    (re.compile(r'\bdownsample\.bn\.bn$'), 'downsample.1'),
    (re.compile(r'\b(bn\d?)\.bn$'), r'\1'),
]
_STATS = {'mean': 'running_mean', 'var': 'running_var'}
# the point head's MLP: 1x1 convs in JAX, Conv1d in the reference
_CONV1D = re.compile(r'\bfcs\.\d+\.conv$')


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_name(path):
    name = '.'.join(path)
    for pat, repl in _MODULE_RULES:
        name = pat.sub(repl, name)
    return name


def _relative_position_index(table_rows):
    ws = (math.isqrt(table_rows) + 1) // 2
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1).astype(np.int64))


def _avg_down(out, keys):
    """Shift each shortcut's conv and BN one slot up (behind the average
    pool of ``avg_down``) where ``keys`` hold the conv there and not in
    slot 0."""
    pat = re.compile(r'^(.*\bdownsample)\.([012])\.(.+)$')
    shift = {m.group(1) for m in map(pat.match, out)
             if m and m.group(2) == '0' and m.group(0) not in keys
             and f'{m.group(1)}.1.{m.group(3)}' in keys}
    moved = {}
    for k, v in out.items():
        m = pat.match(k)
        if m and m.group(1) in shift:
            k = f'{m.group(1)}.{int(m.group(2)) + 1}.{m.group(3)}'
        moved[k] = v
    return moved


def state_dict_from_jax(variables, keys=None):
    """-> {reference-layout key: tensor} for ``load_state_dict``: an
    EncoderDecoder's keys, or an SDModule's ``student.*``, ``teacher.*``
    and ``distill_adapters.*``. ``keys`` (the target's state-dict keys)
    settles the one name the variables leave open: a ``ResNetV1d``
    shortcut's slots behind its average pool."""
    out = _state_dict(variables)
    return out if keys is None else _avg_down(out, set(keys))


def _state_dict(variables):
    if 'student' in variables:
        student = dict(variables['student'])
        params = dict(student.get('params', {}))
        adapters = params.pop('distill_adapters', {})
        student['params'] = params
        out = {f'student.{k}': v
               for k, v in _segmentor_state(student).items()}
        out.update({f'teacher.{k}': v for k, v in
                    _segmentor_state(variables['teacher']).items()})
        out.update({f'distill_adapters.{k}': v for k, v in _segmentor_state(
            {'params': adapters}).items()})
        return out
    return _segmentor_state(variables)


def _segmentor_state(variables):
    out = {}
    for col in ('params', 'batch_stats'):
        for (*path, leaf), value in _flatten(variables.get(col, {})):
            arr = np.asarray(value)
            module = _module_name(path)
            if col == 'batch_stats':
                if leaf not in _STATS:
                    raise KeyError(f'unknown batch_stats leaf {path}/{leaf}')
                leaf = _STATS[leaf]
                out[f'{module}.num_batches_tracked'] = torch.tensor(0)
            elif leaf == 'kernel':
                if arr.ndim == 4 and _CONV1D.search(module):
                    arr = arr[0].transpose(2, 1, 0)  # (1, 1, I, O)
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 3:  # a 1-D conv: (k, I, O) -> (O, I, k)
                    arr = arr.transpose(2, 1, 0)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f'{module}: unexpected kernel shape '
                                     f'{arr.shape}')
                leaf = 'weight'
            elif leaf == 'scale':
                leaf = 'weight'
            elif leaf == 'relative_position_bias_table':
                out[f'{module}.relative_position_index'] = \
                    _relative_position_index(arr.shape[0])
            elif leaf != 'bias':
                raise KeyError(f'unknown parameter {"/".join(path)}/{leaf}')
            out[f'{module}.{leaf}'] = torch.from_numpy(np.ascontiguousarray(
                arr, dtype=np.float64 if arr.dtype == np.float64
                else np.float32))
    return out
