"""JAX variables -> this package's state dict, for the MiT, ResNet
(ResNeXt, ResNeSt), Swin, HRNet, MobileNetV2/V3, Fast-SCNN, CGNet and UNet
backbones, the FPN neck and the SegFormer, PSP, UPer, FCN, separable FCN,
PSA, FPN, point, ASPP, separable ASPP, LRASPP and OCR heads, and the
attention heads NL, GC, DNL, CC, ANN, APC, DM, DA, EMA and Enc.

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
``patch_embed.proj``; ASPP's ``image_pool_conv`` -> ``image_pool.1`` and
``aspp_{i}`` -> ``aspp_modules.{i}``, DeepLabV3+'s ``sep_conv{1,2}`` ->
``sep_bottleneck.{0,1}``, LRASPP's bare ``convs_{i}`` -> ``convs.conv{i}``
and ``conv_ups_{i}`` -> ``conv_ups.conv_up{i}``, OCR's
``object_attention`` -> ``object_context_block`` and ``conv_bn`` -> its
``bottleneck``, a SelfAttentionBlock's ``key_project_{i}`` ->
``key_project[.{i}]`` (a bare conv without its ``.conv`` where it has no
norm), an MNv2 block's ``expand_conv``/``depthwise_conv``/``linear_conv``
-> ``conv.{0,1,2}`` (``conv.{0,1}`` without the expansion), HRNet's
``transition{s}_{i}[_{k}]`` -> ``transition{s}.{i}[.{k}]``,
``stage{s}_m{m}_b{b}.block_{k}`` -> ``stage{s}.{m}.branches.{b}.{k}`` and
``stage{s}_m{m}_fuse.fuse_{i}_{j}[_{k}]`` ->
``stage{s}.{m}.fuse_layers.{i}.{j}[.{k}]`` (a conv/BN pair at slots 0/1);
a PReLU's ``weight`` keeps its name. The attention heads: ANN's
``{fusion,context}.stages_{i}.attn`` -> ``.stages.{i}``, ``acm_{i}`` /
``dcm_{i}`` -> ``acm_modules.{i}`` / ``dcm_modules.{i}`` (a DCM's
``norm.bn`` -> ``norm``), EncNet's ``enc_module.encoding`` /
``encoding_bn.bn`` / ``fc`` -> ``enc_module.encoding.{0,1}`` /
``enc_module.fc.0``, GCNet's ``channel_{add,mul}_conv_{k}`` ->
``channel_{add,mul}_conv.{k}`` (the LayerNorm's affine reshaped to
(planes, 1, 1)); a Scale's and Encoding's ``scale``, CCNet's ``gamma`` and
``codewords`` keep their names; EMANet's ``batch_stats`` leaf
``ema_module_bases`` -> the ``ema_module.bases`` buffer. Swin's bias
tables keep their
name, and each gets the ``relative_position_index`` buffer the reference
``.pth`` carries. Takes the ``{'params', 'batch_stats'}`` tree as numpy
arrays (or anything ``np.asarray`` reads), an SDModule's ``{'student',
'teacher'}`` pair of such trees or an SDModuleMT's ``{'student',
'teachers': [...]}``, whose student params may hold the
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
# the names of this slice's heads and backbones: ASPP's image pool and
# branches, DeepLabV3+'s separable bottleneck, LRASPP's named Sequential
# slots (``convs_0`` a bare conv, FCNHead's a ConvModule), OCR's object
# attention block, HRNet's transitions (``transition1_1_0``: a branch's
# chain step), branches and fuse slots, each conv/BN pair a Sequential
_MODULE_RULES = [
    # the attention heads: ANN's attention stages (the JAX package nests
    # the block under ``attn``), APC's and DM's module lists (a DCM's
    # standalone norm), EncNet's Encoding / BatchNorm1d / gate Sequentials,
    # GCNet's context transforms (conv, LayerNorm, ReLU, conv)
    (re.compile(r'\b(fusion|context)\.stages_(\d+)\.attn\b'),
     r'\1.stages.\2'),
    (re.compile(r'\bacm_(\d+)\b'), r'acm_modules.\1'),
    (re.compile(r'\bdcm_(\d+)\.norm\.bn$'), r'dcm_modules.\1.norm'),
    (re.compile(r'\bdcm_(\d+)\b'), r'dcm_modules.\1'),
    (re.compile(r'\benc_module\.encoding$'), 'enc_module.encoding.0'),
    (re.compile(r'\benc_module\.encoding_bn\.bn$'),
     'enc_module.encoding.1'),
    (re.compile(r'\benc_module\.fc$'), 'enc_module.fc.0'),
    (re.compile(r'\bchannel_(add|mul)_conv_(\d)$'),
     r'channel_\1_conv.\2'),
    # UNet: an encoder stage's conv block sits behind its max pool (slot 1;
    # slot 0 without the pool, which ``keys`` settle), a decoder's under
    # ``conv_block``, its InterpConv's 1x1 ConvModule at
    # ``upsample.interp_upsample.1`` (a plain ``upsample`` ConvModule where
    # the stage neither strided nor pooled: ``keys`` again)
    (re.compile(r'\bencoder_(\d+)\.convs_(\d+)\b'),
     lambda m: f'encoder.{m.group(1)}.{int(m.group(1) != "0")}.convs.'
               f'{m.group(2)}'),
    (re.compile(r'\bdecoder_(\d+)\.convs_(\d+)\b'),
     r'decoder.\1.conv_block.convs.\2'),
    (re.compile(r'\bup_conv_(\d+)\b'),
     r'decoder.\1.upsample.interp_upsample.1'),
    # CGNet: the stem's ConvModules, the norm-PReLU Sequentials (BN at 0,
    # PReLU at 1), the level blocks, the global context's Linear slots
    (re.compile(r'\bstem_(\d)\b'), r'stem.\1'),
    (re.compile(r'\bnorm_prelu_(\d)_bn\.bn$'), r'norm_prelu_\1.0'),
    (re.compile(r'\bnorm_prelu_(\d)_act$'), r'norm_prelu_\1.1'),
    (re.compile(r'\blevel(\d)_(\d+)\b'), r'level\1.\2'),
    (re.compile(r'\bf_glo\.fc([12])$'),
     lambda m: f'f_glo.fc.{2 * int(m.group(1)) - 2}'),
    # Fast-SCNN: the children of its three sub-modules
    (re.compile(r'\bld_conv\b'), 'learning_to_downsample.conv'),
    (re.compile(r'\bld_dsconv(\d)\b'),
     r'learning_to_downsample.dsconv\1'),
    (re.compile(r'\bbottleneck(\d)_(\d+)\b'),
     r'global_feature_extractor.bottleneck\1.\2'),
    (re.compile(r'\bppm\.pool_(\d+)\b'),
     r'global_feature_extractor.ppm.\1.1'),
    (re.compile(r'\bgfe_out\b'), 'global_feature_extractor.out'),
    (re.compile(r'\bffm_dwconv\b'), 'feature_fusion.dwconv'),
    (re.compile(r'\bffm_conv_(lower|higher)\b'),
     r'feature_fusion.conv_\1_res'),
    (re.compile(r'\bimage_pool_conv\b'), 'image_pool.1'),
    (re.compile(r'\baspp_(\d+)\b'), r'aspp_modules.\1'),
    (re.compile(r'\bsep_conv([12])\b'),
     lambda m: f'sep_bottleneck.{int(m.group(1)) - 1}'),
    (re.compile(r'\bconvs_(\d+)$'), r'convs.conv\1'),
    (re.compile(r'\bconv_ups_(\d+)\b'), r'conv_ups.conv_up\1'),
    (re.compile(r'\bconv_bn\b'), 'object_context_block.bottleneck'),
    (re.compile(r'\bobject_attention\b'), 'object_context_block'),
    (re.compile(r'\btransition(\d)_(\d+)(?:_(\d+))?\.(conv|bn\.bn)$'),
     lambda m: f'transition{m.group(1)}.{m.group(2)}.'
               + (f'{m.group(3)}.' if m.group(3) else '')
               + ('0' if m.group(4) == 'conv' else '1')),
    (re.compile(r'\bstage(\d)_m(\d+)_b(\d+)\.block_(\d+)\b'),
     r'stage\1.\2.branches.\3.\4'),
    (re.compile(r'\bstage(\d)_m(\d+)_fuse\.fuse_(\d+)_(\d+)(?:_(\d+))?'
                r'\.(conv|bn\.bn)$'),
     lambda m: f'stage{m.group(1)}.{m.group(2)}.fuse_layers.{m.group(3)}.'
               f'{m.group(4)}.' + (f'{m.group(5)}.' if m.group(5) else '')
               + ('0' if m.group(6) == 'conv' else '1')),
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
# buffers held in ``batch_stats`` beside the norms' statistics: EMANet's
# bases (JAX leaf -> the name under the leaf's module)
_BUFFERS = {'ema_module_bases': 'ema_module.bases'}
# parameters kept under their own names: a Scale's (DANet's ``gamma``) and
# Encoding's ``scale``, CCNet's bare ``gamma``, Encoding's ``codewords``
_KEPT_SCALE = re.compile(r'(\.gamma|\bencoding\.0)$')
_OWN_LEAVES = ('gamma', 'codewords')
# GCNet's LayerNorm([planes, 1, 1]) holds (planes, 1, 1) affine tensors
_CONTEXT_LN = re.compile(r'\bchannel_(add|mul)_conv\.1$')
# the point head's MLP: 1x1 convs in JAX, Conv1d in the reference
_CONV1D = re.compile(r'\bfcs\.\d+\.conv$')


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


# names whose reference form depends on their siblings: an MNv2
# InvertedResidual's Sequential slots (no expansion conv at expand ratio 1:
# the depthwise conv moves to slot 0), and a SelfAttentionBlock projection
# (a Sequential only where it has several convs; a bare conv where it has
# no norm, so the ConvModule's ``conv`` goes)
_MNV2_SLOT = re.compile(r'\b(layer\d+_\d+|bottleneck\d_\d+)\.(expand_conv|'
                        r'depthwise_conv|linear_conv)\b')
_PROJECT = re.compile(r'\b((key|query|value|out)_project)_(\d+)(\.conv)?\b')


def _in_context(name, names):
    def mnv2(m):
        prefix = name[:m.start()] + m.group(1)
        slot = ('expand_conv', 'depthwise_conv', 'linear_conv').index(
            m.group(2)) - (f'{prefix}.expand_conv' not in names)
        return f'{m.group(1)}.conv.{slot}'

    def project(m):
        prefix = name[:m.start()] + m.group(1)
        many = f'{prefix}_1' in names
        bare = f'{prefix}_{m.group(3)}.bn' not in names
        return m.group(1) + (f'.{m.group(3)}' if many else '') + \
            ('' if bare else m.group(4) or '')
    return _PROJECT.sub(project, _MNV2_SLOT.sub(mnv2, name))


def _module_name(path, names=()):
    name = _in_context('.'.join(path), names)
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
    EncoderDecoder's keys, an SDModule's ``student.*``, ``teacher.*``
    and ``distill_adapters.*``, or an SDModuleMT's ``student.*``,
    ``teachers.{i}.*`` and ``distill_adapters.*``. ``keys`` (the target's
    state-dict keys) settles the names the variables leave open: a
    ``ResNetV1d`` shortcut's slots behind its average pool, and a UNet
    stage's conv block without a pool in front (``encoder.{i}.0``) or
    decoder upsample without the InterpConv (``decoder.{i}.upsample``)."""
    out = _state_dict(variables)
    if keys is None:
        return out
    keys = set(keys)
    return _unet_slots(_avg_down(out, keys), keys)


# a UNet name as the rules give it -> its form where the stage has no max
# pool, or the decoder no InterpConv
_UNET_ALTERNATES = [(re.compile(r'\b(encoder\.\d+)\.1\.'), r'\1.0.'),
                    (re.compile(r'\bupsample\.interp_upsample\.1\.'),
                     'upsample.')]


def _unet_slots(out, keys):
    moved = {}
    for k, v in out.items():
        if k not in keys:
            for pat, repl in _UNET_ALTERNATES:
                alt = pat.sub(repl, k)
                if alt in keys:
                    k = alt
                    break
        moved[k] = v
    return moved


def _state_dict(variables):
    if 'student' in variables:
        student = dict(variables['student'])
        params = dict(student.get('params', {}))
        adapters = params.pop('distill_adapters', {})
        student['params'] = params
        out = {f'student.{k}': v
               for k, v in _segmentor_state(student).items()}
        if 'teachers' in variables:  # an SDModuleMT
            for i, teacher in enumerate(variables['teachers']):
                out.update({f'teachers.{i}.{k}': v for k, v in
                            _segmentor_state(teacher).items()})
        else:
            out.update({f'teacher.{k}': v for k, v in
                        _segmentor_state(variables['teacher']).items()})
        out.update({f'distill_adapters.{k}': v for k, v in _segmentor_state(
            {'params': adapters}).items()})
        return out
    return _segmentor_state(variables)


def _segmentor_state(variables):
    out = {}
    names = {'.'.join(path[:i + 1])
             for col in ('params', 'batch_stats')
             for path, _ in _flatten(variables.get(col, {}))
             for i in range(len(path))}
    for col in ('params', 'batch_stats'):
        for (*path, leaf), value in _flatten(variables.get(col, {})):
            arr = np.asarray(value)
            module = _module_name(path, names)
            if col == 'batch_stats' and leaf in _BUFFERS:
                out[f'{module}.{_BUFFERS[leaf]}'] = _tensor(arr)
                continue
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
            elif leaf == 'scale' and not _KEPT_SCALE.search(module):
                leaf = 'weight'
            elif leaf == 'relative_position_bias_table':
                out[f'{module}.relative_position_index'] = \
                    _relative_position_index(arr.shape[0])
            elif leaf not in ('bias', 'weight', 'scale') + _OWN_LEAVES:
                # PReLU's slopes: weight
                raise KeyError(f'unknown parameter {"/".join(path)}/{leaf}')
            if _CONTEXT_LN.search(module):
                arr = arr.reshape(-1, 1, 1)
            out[f'{module}.{leaf}'] = _tensor(arr)
    return out


def _tensor(arr):
    """float64 stays float64, anything else becomes float32."""
    return torch.from_numpy(np.ascontiguousarray(
        arr, dtype=np.float64 if arr.dtype == np.float64 else np.float32))
