"""Model and recipe functions backing the config corpus.

The reference's ``local_configs`` repeat full model dicts in every file;
here configs compose these functions so each experiment file states only its
deltas. The produced dicts preserve the reference's declarative contract
exactly (SURVEY §2.1 "Distillation config API"). The port's own copy of
``segdistill_tpu/zoo.py`` (plain dicts, no framework): the config loader
serves it where a config imports ``segdistill_tpu.zoo``.
"""

import copy

MIT_CHANNELS = {
    'b0': [32, 64, 160, 256],
    'b1': [64, 128, 320, 512],
    'b2': [64, 128, 320, 512],
    'b3': [64, 128, 320, 512],
    'b4': [64, 128, 320, 512],
    'b5': [64, 128, 320, 512],
}
# official SegFormer decoder widths
MIT_EMBED_DIM = {'b0': 256, 'b1': 256, 'b2': 768, 'b3': 768, 'b4': 768,
                 'b5': 768}

NORM_CFG = dict(type='SyncBN', requires_grad=True)
CE_LOSS = dict(type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)


def segformer(variant='b0', num_classes=150, pretrained=None,
              embed_dim=None, dtype=None):
    """Segformer EncoderDecoder dict (ref exp_tab5/segformer_CGD.py:8-44)."""
    backbone = dict(type=f'mit_{variant}', style='pytorch')
    if dtype:
        backbone['dtype'] = dtype
    cfg = dict(
        type='EncoderDecoder',
        backbone=backbone,
        decode_head=dict(
            type='SegFormerHead',
            in_channels=list(MIT_CHANNELS[variant]),
            in_index=[0, 1, 2, 3],
            feature_strides=[4, 8, 16, 32],
            channels=128,
            dropout_ratio=0.1,
            num_classes=num_classes,
            norm_cfg=dict(NORM_CFG),
            align_corners=False,
            decoder_params=dict(
                embed_dim=embed_dim or MIT_EMBED_DIM[variant]),
            loss_decode=dict(CE_LOSS)))
    if pretrained:
        cfg['pretrained'] = pretrained
    return cfg


def swin_tiny_upernet(num_classes=150, pretrained=None):
    """Swin-T + UPerHead student (ref exp_tab5/swin_CGD.py:27-57)."""
    cfg = dict(
        type='EncoderDecoder',
        backbone=dict(
            type='SwinTransformer', embed_dim=96, depths=(2, 2, 6, 2),
            num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
            qkv_bias=True, drop_rate=0.0, attn_drop_rate=0.0,
            drop_path_rate=0.3, ape=False, patch_norm=True,
            out_indices=(0, 1, 2, 3)),
        decode_head=dict(
            type='UPerHead', in_channels=[96, 192, 384, 768],
            in_index=[0, 1, 2, 3], pool_scales=(1, 2, 3, 6), channels=512,
            dropout_ratio=0.1, num_classes=num_classes,
            norm_cfg=dict(NORM_CFG), align_corners=False,
            loss_decode=dict(CE_LOSS)))
    if pretrained:
        cfg['pretrained'] = pretrained
    return cfg


def pspnet_r50(num_classes=150, depth=50, pretrained=None):
    """PSPNet ResNetV1c-d8 student (ref exp_tab5/psp_CGD.py:26-51)."""
    cfg = dict(
        type='EncoderDecoder',
        backbone=dict(
            type='ResNetV1c', depth=depth, num_stages=4,
            out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
            strides=(1, 2, 1, 1), norm_cfg=dict(NORM_CFG), norm_eval=False,
            style='pytorch', contract_dilation=True),
        decode_head=dict(
            type='PSPHead', in_channels=2048, in_index=3, channels=512,
            pool_scales=(1, 2, 3, 6), dropout_ratio=0.1,
            num_classes=num_classes, norm_cfg=dict(NORM_CFG),
            align_corners=False, loss_decode=dict(CE_LOSS)))
    if pretrained:
        cfg['pretrained'] = pretrained
    return cfg


def psanet_r50(num_classes=150, depth=50, pretrained=None):
    """PSANet ResNetV1c-d8 (ref configs/_base_/models/psanet_r50-d8.py).
    mask_size (97, 97) > the 64x64 stride-8 feature map, so at 512^2 every
    position attends everywhere, exactly like the reference default."""
    cfg = dict(
        type='EncoderDecoder',
        backbone=dict(
            type='ResNetV1c', depth=depth, num_stages=4,
            out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
            strides=(1, 2, 1, 1), norm_cfg=dict(NORM_CFG), norm_eval=False,
            style='pytorch', contract_dilation=True),
        decode_head=dict(
            type='PSAHead', in_channels=2048, in_index=3, channels=512,
            mask_size=(97, 97), psa_type='bi-direction', compact=False,
            shrink_factor=2, normalization_factor=1.0, psa_softmax=True,
            dropout_ratio=0.1, num_classes=num_classes,
            norm_cfg=dict(NORM_CFG), align_corners=False,
            loss_decode=dict(CE_LOSS)),
        auxiliary_head=dict(
            type='FCNHead', in_channels=1024, in_index=2, channels=256,
            num_convs=1, concat_input=False, dropout_ratio=0.1,
            num_classes=num_classes, norm_cfg=dict(NORM_CFG),
            align_corners=False,
            loss_decode=dict(CE_LOSS, loss_weight=0.4)))
    if pretrained:
        cfg['pretrained'] = pretrained
    return cfg


def pointrend_r50(num_classes=150, pretrained=None):
    """PointRend (ref configs/point_rend/ + _base_/models/pointrend_r50.py):
    ResNetV1c + FPN neck, FPNHead coarse stage + PointHead refinement.
    The reference's train_cfg/test_cfg point-sampling keys are carried as
    PointHead attributes (static shapes under jit)."""
    cfg = dict(
        type='CascadeEncoderDecoder',
        num_stages=2,
        backbone=dict(
            type='ResNetV1c', depth=50, num_stages=4,
            out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 1),
            strides=(1, 2, 2, 2), norm_cfg=dict(NORM_CFG), norm_eval=False,
            style='pytorch', contract_dilation=True),
        neck=dict(type='FPN', in_channels=[256, 512, 1024, 2048],
                  out_channels=256, num_outs=4),
        decode_head=[
            dict(type='FPNHead', in_channels=[256, 256, 256, 256],
                 in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
                 channels=128, dropout_ratio=-1, num_classes=num_classes,
                 norm_cfg=dict(NORM_CFG), align_corners=False,
                 loss_decode=dict(CE_LOSS)),
            dict(type='PointHead', in_channels=[256], in_index=[0],
                 channels=256, num_fcs=3, coarse_pred_each_layer=True,
                 dropout_ratio=-1, num_classes=num_classes,
                 align_corners=False, loss_decode=dict(CE_LOSS),
                 num_points=2048, oversample_ratio=3,
                 importance_sample_ratio=0.75, subdivision_steps=2,
                 subdivision_num_points=8196, scale_factor=2)],
        train_cfg=dict(num_points=2048, oversample_ratio=3,
                       importance_sample_ratio=0.75),
        test_cfg=dict(mode='whole', subdivision_steps=2,
                      subdivision_num_points=8196, scale_factor=2))
    if pretrained:
        cfg['pretrained'] = pretrained
    return cfg


TEACHER_B3_CKPT = './pretrained/segformer.b3.512x512.ade.160k.pth'


def distill_entry(loss_name, loss_config=None,
                  student_layer='decode_head.linear_pred',
                  teacher_layer='decode_head.linear_pred'):
    return {'student_layer': student_layer, 'teacher_layer': teacher_layer,
            'loss_name': loss_name, 'loss_config': loss_config or {}}


def sd_model(cfg_s, cfg_t, distillation, t_pretrain=TEACHER_B3_CKPT,
             s_pretrain=None):
    """(ref contract: local_configs/exp_tab5/segformer_CGD.py:45-59)."""
    model = dict(type='SDModule', cfg_s=cfg_s, cfg_t=cfg_t,
                 distillation=distillation, t_pretrain=t_pretrain,
                 train_cfg=dict(), test_cfg=dict(mode='whole'))
    if s_pretrain:
        model['s_pretrain'] = s_pretrain
    return model


def distill_adamw():
    """Student AdamW recipe (ref exp_tab5/segformer_CGD.py:60-64)."""
    return dict(
        _delete_=True, type='AdamW', lr=0.00006, betas=(0.9, 0.999),
        weight_decay=0.01,
        paramwise_cfg=dict(custom_keys={
            'pos_block': dict(decay_mult=0.),
            'norm': dict(decay_mult=0.),
            'head': dict(lr_mult=10.)}))


def swin_adamw():
    """Swin student AdamW recipe (ref exp_tab5/swin_CGD.py:74-77)."""
    return dict(
        _delete_=True, type='AdamW', lr=0.00006, betas=(0.9, 0.999),
        weight_decay=0.01,
        paramwise_cfg=dict(custom_keys={
            'absolute_pos_embed': dict(decay_mult=0.),
            'relative_position_bias_table': dict(decay_mult=0.),
            'norm': dict(decay_mult=0.)}))


def poly_warmup_lr():
    """(ref exp_tab5/segformer_CGD.py:66-70)."""
    return dict(_delete_=True, policy='poly', warmup='linear',
                warmup_iters=1500, warmup_ratio=1e-6, power=1.0,
                min_lr=0.0, by_epoch=False)
