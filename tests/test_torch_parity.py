"""End-to-end torch<->flax numerical parity (VERDICT round-1 item 1).

The gate for the mIoU-parity claim: random-init a torch oracle replica of
the reference model (tests/torch_ref/), save its ``.pth``, load it through
the production converter (segdistill_tpu/convert/torch_loader.py), and
assert

* fp32 logit parity on random inputs (model + converter correct), and
* a seeded multi-step SGD loss trajectory matches (training step correct).

This is the CI test that would have caught commit e965bf7's square-matrix
transpose bug automatically.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from segdistill_tpu.convert.torch_loader import load_pth_into_variables
from segdistill_tpu.models import build_segmentor

import torch_port_threads  # noqa: F401  (torch threads a test worker)

# compile-heavy on the 1-core CI box -> slow tier (fast tier = <3 min signal)
pytestmark = pytest.mark.slow

NORM = dict(type='SyncBN', requires_grad=True)


def _randomize(model, seed=0):
    """Random values in every tensor (incl. BN running stats) so that any
    mis-mapped or mis-transposed leaf shows up as a logit mismatch."""
    g = torch.Generator().manual_seed(seed)
    prelus = {f'{name}.weight' for name, m in model.named_modules()
              if isinstance(m, torch.nn.PReLU)}
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith('num_batches_tracked') or not v.is_floating_point():
            continue  # index buffers stay intact
        if v.ndim == 0:  # mmcv Scale gammas: nonzero so the branch runs
            sd[k] = 0.3 + 0.4 * torch.rand((), generator=g)
            continue
        if 'running_var' in k:
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif 'running_mean' in k:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k in prelus:
            # realistic slopes (torch init 0.25): a "norm-scale" ~1.1
            # slope makes PReLU near-linear, so CGNet's 21 residual
            # blocks amplify activations geometrically (measured 8.8 ->
            # 637 over stage 2) and fp32-vs-fp32 roundoff outgrows any
            # absolute tolerance while staying ~1e-8 RELATIVE
            sd[k] = 0.25 * torch.rand(v.shape, generator=g)
        elif v.ndim == 1 and k.endswith('weight'):  # norm scales
            sd[k] = 1.0 + 0.2 * torch.rand(v.shape, generator=g)
        elif v.ndim == 1:  # biases
            sd[k] = 0.02 * torch.randn(v.shape, generator=g)
        else:
            fan_in = int(np.prod(v.shape[1:]))
            sd[k] = torch.randn(v.shape, generator=g) / np.sqrt(fan_in)
    model.load_state_dict(sd)
    return model


def _build_torch_segformer(num_classes=19, embed_dim=64):
    from torch_ref.heads import EncoderDecoder, SegFormerHead
    from torch_ref.mit import mit_b0
    head = SegFormerHead([32, 64, 160, 256], embed_dim, num_classes)
    return EncoderDecoder(mit_b0(), head)


def _segformer_cfg(num_classes=19, embed_dim=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='mit_b0', gelu_approximate=False,
                      drop_path_rate=0.0),
        decode_head=dict(
            type='SegFormerHead', in_channels=[32, 64, 160, 256],
            in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
            channels=128, dropout_ratio=0.0, num_classes=num_classes,
            norm_cfg=NORM, align_corners=False,
            decoder_params=dict(embed_dim=embed_dim)),
        test_cfg=dict(mode='whole'))


def _convert(flax_model, torch_model, tmp_path, shape):
    path = str(tmp_path / 'oracle.pth')
    torch.save(torch_model.state_dict(), path)
    variables = flax_model.init_variables(jax.random.PRNGKey(0), shape)
    return load_pth_into_variables(variables, path, strict=True)


class TestSegformerB0Parity:
    """MiT-b0 + SegFormerHead: the flagship student."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_segformer()).eval()
        fmodel = build_segmentor(_segformer_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('segformer'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-5,
                err_msg=f'backbone stage {s + 1} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-5)

    def test_train_trajectory(self, setup, tmp_path):
        """~8 seeded SGD steps: same batches, same loss trajectory.

        Proves the whole jitted train step (forward in train mode, resized
        CE with reduction='none'+mean, backward, SGD update) matches the
        torch semantics (ref base.py:128-209 + decode_head.py:217-237)."""
        tmodel, fmodel, variables = setup
        import copy
        tmodel = copy.deepcopy(tmodel).train()

        from segdistill_tpu.engine import (build_train_step,
                                           create_train_state,
                                           build_optimizer)
        lr = 0.05
        rs = np.random.RandomState(3)
        batches = [(rs.randn(2, 3, 64, 64).astype(np.float32),
                    np.where(rs.rand(2, 64, 64) < 0.1, 255,
                             rs.randint(0, 19, (2, 64, 64))).astype(np.int32))
                   for _ in range(8)]

        opt = torch.optim.SGD(tmodel.parameters(), lr=lr)
        t_losses = []
        for img, gt in batches:
            opt.zero_grad()
            loss = tmodel.loss(torch.from_numpy(img),
                               torch.from_numpy(gt).long())
            loss.backward()
            opt.step()
            t_losses.append(float(loss.detach()))

        tx = build_optimizer(dict(type='SGD', lr=lr, momentum=0.0,
                                  weight_decay=0.0), variables['params'])
        state = create_train_state(jax.random.PRNGKey(0), variables, tx)
        train_step = build_train_step(fmodel, tx, donate=False)
        f_losses = []
        for img, gt in batches:
            state, log_vars = train_step(
                state, {}, jnp.asarray(img.transpose(0, 2, 3, 1)),
                jnp.asarray(gt))
            f_losses.append(float(log_vars['loss']))

        np.testing.assert_allclose(f_losses, t_losses, rtol=2e-4,
                                   err_msg=f'flax {f_losses} vs torch '
                                           f'{t_losses}')


def _build_torch_psp(num_classes=19, channels=128, aux_channels=64):
    from torch_ref.heads import EncoderDecoder, FCNHead, PSPHead
    from torch_ref.resnet import ResNetV1c
    return EncoderDecoder(
        ResNetV1c(depth=50), PSPHead(2048, channels, num_classes),
        auxiliary_head=FCNHead(1024, aux_channels, num_classes))


def _psp_cfg(num_classes=19, channels=128, aux_channels=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=NORM,
                      contract_dilation=True, style='pytorch'),
        decode_head=dict(type='PSPHead', in_channels=2048, in_index=3,
                         channels=channels, pool_scales=(1, 2, 3, 6),
                         dropout_ratio=0.0, num_classes=num_classes,
                         norm_cfg=NORM, align_corners=False),
        auxiliary_head=dict(type='FCNHead', in_channels=1024, in_index=2,
                            channels=aux_channels, num_convs=1,
                            concat_input=False, dropout_ratio=0.0,
                            num_classes=num_classes, norm_cfg=NORM,
                            align_corners=False,
                            loss_decode=dict(type='CrossEntropyLoss',
                                             use_sigmoid=False,
                                             loss_weight=0.4)),
        test_cfg=dict(mode='whole'))


class TestPSPResNetParity:
    """ResNetV1c-50-d8 + PSPHead + FCN aux: the CNN student family."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_psp(), seed=5).eval()
        fmodel = build_segmentor(_psp_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('psp'), (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(6).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=True)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-5)
        with torch.no_grad():
            t_aux = tmodel.auxiliary_head(
                tmodel.backbone(torch.from_numpy(x))).numpy()
        f_aux = np.asarray(outs['aux'], np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_aux, t_aux, rtol=1e-4, atol=1e-5)

    def test_step0_gradient_cosine(self, setup):
        """Structural gradient check. Elementwise comparison is the wrong
        gate for a BN-heavy CNN: BN scale-invariance makes pre-BN weight
        grads near-perfect cancellations of large terms, so their fp32
        values are noise at the ~1e-4 level (verified: torch's own f64
        finite difference disagrees with torch autograd on those elements
        by the same margin as flax does). Cosine similarity of the
        gradient direction is noise-robust and catches every structural
        bug (wrong layout, missing stop_gradient, wrong loss weight)."""
        tmodel, fmodel, variables = setup
        import copy
        tmodel = copy.deepcopy(tmodel).train()
        rs = np.random.RandomState(7)
        img = rs.randn(2, 3, 64, 64).astype(np.float32)
        gt = np.where(rs.rand(2, 64, 64) < 0.1, 255,
                      rs.randint(0, 19, (2, 64, 64))).astype(np.int32)

        loss = tmodel.loss(torch.from_numpy(img),
                           torch.from_numpy(gt).long())
        loss.backward()
        tgrads = {k: p.grad.detach().numpy() for k, p in
                  tmodel.named_parameters() if p.grad is not None}

        import flax
        from segdistill_tpu.convert.torch_loader import _translate_base
        from segdistill_tpu.models.segmentors import parse_losses
        ms = {k: v for k, v in variables.items() if k != 'params'}

        def loss_fn(params):
            losses, _, _ = fmodel.forward_train(
                {'params': params, **ms},
                jnp.asarray(img.transpose(0, 2, 3, 1)), jnp.asarray(gt),
                rngs={'dropout': jax.random.PRNGKey(0)})
            return parse_losses(losses)[0]

        fval, grads = jax.value_and_grad(loss_fn)(variables['params'])
        np.testing.assert_allclose(float(fval), float(loss.detach()),
                                   rtol=1e-5)
        flat = {'.'.join(k): np.asarray(v) for k, v in
                flax.traverse_util.flatten_dict(grads).items()}
        tv, fv = [], []
        for tk, tg in tgrads.items():
            comps = _translate_base(tk).split('.')
            if tk.endswith('weight'):
                cands = (['.'.join(comps[:-1]) + '.kernel']
                         if tg.ndim >= 2 else
                         ['.'.join(comps[:-1]) + '.scale',
                          '.'.join(comps[:-1]) + '.bn.scale'])
            else:
                cands = ['.'.join(comps[:-1]) + '.bias',
                         '.'.join(comps[:-1]) + '.bn.bias']
            fk = next((c for c in cands if c in flat), None)
            assert fk is not None, f'no flax grad found for {tk}'
            fg = flat[fk]
            if tg.ndim == 4:
                fg = fg.transpose(3, 2, 0, 1)
            elif tg.ndim == 2:
                fg = fg.T
            if np.linalg.norm(tg) < 1e-6 and np.linalg.norm(fg) < 1e-6:
                # Analytically-zero gradient: a bias on a purely linear
                # path into a train-mode BN (e.g. MNv2 linear_conv has no
                # act; SegFormer proj bias feeds resize+concat+BN) — mean
                # subtraction kills constant shifts exactly, so both
                # sides hold fp32 residue (~1e-8) whose direction is
                # meaningless. Both frameworks agreeing it is ~0 IS the
                # parity statement; exclude it from the cosine gates.
                continue
            cos = np.dot(tg.ravel(), fg.ravel()) / (
                np.linalg.norm(tg) * np.linalg.norm(fg) + 1e-30)
            assert cos > 0.995, f'{tk}: grad cosine {cos}'
            tv.append(tg.ravel())
            fv.append(fg.ravel())
        t, f = np.concatenate(tv), np.concatenate(fv)
        g_cos = np.dot(t, f) / (np.linalg.norm(t) * np.linalg.norm(f))
        assert g_cos > 0.999, f'global grad cosine {g_cos}'

    @pytest.mark.slow
    def test_train_trajectory(self, setup):
        """Covers the aux-head 0.4-weighted loss sum and BN-in-train-mode
        (SyncBN parity) through the jitted step. Tolerance is looser than
        the Segformer trajectory: see test_step0_gradient_cosine — the
        BN-cancellation fp32 noise floor walks the trajectories apart at
        the ~0.5% level within a few steps (torch FD vs torch autograd
        shows the same spread)."""
        tmodel, fmodel, variables = setup
        import copy
        tmodel = copy.deepcopy(tmodel).train()

        from segdistill_tpu.engine import (build_train_step,
                                           create_train_state,
                                           build_optimizer)
        lr = 0.02
        rs = np.random.RandomState(7)
        batches = [(rs.randn(2, 3, 64, 64).astype(np.float32),
                    np.where(rs.rand(2, 64, 64) < 0.1, 255,
                             rs.randint(0, 19, (2, 64, 64))).astype(np.int32))
                   for _ in range(6)]

        opt = torch.optim.SGD(tmodel.parameters(), lr=lr)
        t_losses = []
        for img, gt in batches:
            opt.zero_grad()
            loss = tmodel.loss(torch.from_numpy(img),
                               torch.from_numpy(gt).long())
            loss.backward()
            opt.step()
            t_losses.append(float(loss.detach()))

        tx = build_optimizer(dict(type='SGD', lr=lr, momentum=0.0,
                                  weight_decay=0.0), variables['params'])
        state = create_train_state(jax.random.PRNGKey(0), variables, tx)
        train_step = build_train_step(fmodel, tx, donate=False)
        f_losses = []
        for img, gt in batches:
            state, log_vars = train_step(
                state, {}, jnp.asarray(img.transpose(0, 2, 3, 1)),
                jnp.asarray(gt))
            f_losses.append(float(log_vars['loss']))

        np.testing.assert_allclose(f_losses, t_losses, rtol=1e-2,
                                   err_msg=f'flax {f_losses} vs torch '
                                           f'{t_losses}')


def _build_torch_swin(num_classes=19, channels=64):
    from torch_ref.heads import EncoderDecoder, UPerHead
    from torch_ref.swin import SwinTransformer
    bb = SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2),
                         num_heads=(3, 6, 12, 24), window_size=7)
    head = UPerHead([96, 192, 384, 768], channels, num_classes)
    return EncoderDecoder(bb, head)


def _swin_cfg(num_classes=19, channels=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='SwinTransformer', embed_dim=96,
                      depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                      window_size=7, drop_path_rate=0.0, drop_rate=0.0,
                      gelu_approximate=False),
        decode_head=dict(type='UPerHead', in_channels=[96, 192, 384, 768],
                         in_index=[0, 1, 2, 3], pool_scales=(1, 2, 3, 6),
                         channels=channels, dropout_ratio=0.0,
                         num_classes=num_classes, norm_cfg=NORM,
                         align_corners=False),
        test_cfg=dict(mode='whole'))


class TestSwinUPerParity:
    """Swin-T + UPerHead: the third student family of exp_tab5 and the
    most conversion-fragile model (rel-pos bias tables, fused qkv,
    shifted-window masks)."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_swin(), seed=9).eval()
        fmodel = build_segmentor(_swin_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('swin'),
                             (1, 56, 56, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        # 56 = 8 windows at stage1 (14x14 maps at stage 3, 7x7 at stage 4:
        # exercises both whole-window and padded/shifted paths)
        x = np.random.RandomState(8).randn(2, 3, 56, 56).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            np.testing.assert_allclose(
                np.asarray(f, np.float32).transpose(0, 3, 1, 2), t.numpy(),
                rtol=1e-4, atol=1e-5,
                err_msg=f'swin stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(9).randn(2, 3, 56, 56).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-5)

    def test_step0_gradient_cosine(self, setup):
        """Structural gradient check for the Swin/UPer pair (UPerHead is
        BN-heavy: same cosine gate rationale as TestPSPResNetParity)."""
        tmodel, fmodel, variables = setup
        import copy
        tmodel = copy.deepcopy(tmodel).train()
        rs = np.random.RandomState(10)
        img = rs.randn(2, 3, 56, 56).astype(np.float32)
        gt = np.where(rs.rand(2, 56, 56) < 0.1, 255,
                      rs.randint(0, 19, (2, 56, 56))).astype(np.int32)

        loss = tmodel.loss(torch.from_numpy(img),
                           torch.from_numpy(gt).long())
        loss.backward()
        tgrads = {k: p.grad.detach().numpy() for k, p in
                  tmodel.named_parameters() if p.grad is not None}

        import flax
        from segdistill_tpu.convert.torch_loader import _translate_base
        from segdistill_tpu.models.segmentors import parse_losses
        ms = {k: v for k, v in variables.items() if k != 'params'}

        def loss_fn(params):
            losses, _, _ = fmodel.forward_train(
                {'params': params, **ms},
                jnp.asarray(img.transpose(0, 2, 3, 1)), jnp.asarray(gt),
                rngs={'dropout': jax.random.PRNGKey(0)})
            return parse_losses(losses)[0]

        fval, grads = jax.value_and_grad(loss_fn)(variables['params'])
        np.testing.assert_allclose(float(fval), float(loss.detach()),
                                   rtol=1e-4)
        flat = {'.'.join(k): np.asarray(v) for k, v in
                flax.traverse_util.flatten_dict(grads).items()}
        tv, fv = [], []
        for tk, tg in tgrads.items():
            comps = _translate_base(tk).split('.')
            if tk.endswith('weight'):
                cands = (['.'.join(comps[:-1]) + '.kernel']
                         if tg.ndim >= 2 else
                         ['.'.join(comps[:-1]) + '.scale',
                          '.'.join(comps[:-1]) + '.bn.scale'])
            else:
                cands = ['.'.join(comps[:-1]) + '.bias',
                         '.'.join(comps[:-1]) + '.bn.bias',
                         _translate_base(tk)]
            # UPerHead's torch 'bottleneck' lives at flax 'psp_bottleneck'
            # (converter _BASE_ALTERNATES)
            cands += [c.replace('.bottleneck.', '.psp_bottleneck.')
                      for c in cands]
            fk = next((c for c in cands if c in flat), None)
            assert fk is not None, f'no flax grad found for {tk}'
            fg = flat[fk]
            if tg.ndim == 4:
                fg = fg.transpose(3, 2, 0, 1)
            elif tg.ndim == 2:
                fg = fg.T
            tv.append(tg.ravel())
            fv.append(fg.ravel())
        t, f = np.concatenate(tv), np.concatenate(fv)
        g_cos = np.dot(t, f) / (np.linalg.norm(t) * np.linalg.norm(f))
        assert g_cos > 0.999, f'global grad cosine {g_cos}'


def _build_torch_mnv2(num_classes=19, embed_dim=64):
    from torch_ref.heads import EncoderDecoder, SegFormerHead
    from torch_ref.mobilenet import MobileNetV2
    head = SegFormerHead([24, 32, 96, 320], embed_dim, num_classes)
    return EncoderDecoder(MobileNetV2(), head)


def _mnv2_cfg(num_classes=19, embed_dim=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='MobileNetV2', norm_cfg=NORM),
        decode_head=dict(
            type='SegFormerHead', in_channels=[24, 32, 96, 320],
            in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
            channels=128, dropout_ratio=0.0, num_classes=num_classes,
            norm_cfg=NORM, align_corners=False,
            decoder_params=dict(embed_dim=embed_dim)),
        test_cfg=dict(mode='whole'))


def _grad_cosine_f64(tmodel, cfg, variables, num_classes=19, seed=14,
                     img_hw=64):
    """Shared f64 step-0 gradient-parity gate for BN-heavy CNNs.

    Runs in float64 on BOTH sides (jax.enable_x64 + ``.double()``,
    rebuilding the flax model with ``backbone.dtype=float64`` — the
    backbones cast inputs to their configured compute dtype, so the f32
    default would silently undo x64): tens of train-mode-BN convs deep,
    fp32 alone accumulates enough noise that the honest f32 global cosine
    is ~0.9988 (measured on MNv2); the f64 run pins every real-gradient
    tensor, proving that residue is precision, not semantics. x64 also
    exercises the tap-sum dwconv's dtype-promoting accumulator
    (ops/dwconv.py)."""
    import copy
    cfg = copy.deepcopy(cfg)
    cfg['backbone']['dtype'] = jnp.float64
    fmodel = build_segmentor(cfg)
    tmodel = copy.deepcopy(tmodel).train().double()
    rs = np.random.RandomState(seed)
    img = rs.randn(2, 3, img_hw, img_hw)
    gt = np.where(rs.rand(2, img_hw, img_hw) < 0.1, 255,
                  rs.randint(0, num_classes,
                             (2, img_hw, img_hw))).astype(np.int32)

    loss = tmodel.loss(torch.from_numpy(img), torch.from_numpy(gt).long())
    loss.backward()
    tgrads = {k: p.grad.detach().numpy() for k, p in
              tmodel.named_parameters() if p.grad is not None}

    import flax
    from segdistill_tpu.convert.torch_loader import _translate_base
    from segdistill_tpu.models.segmentors import parse_losses

    with jax.enable_x64(True):
        v64 = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64)
            if a.dtype == jnp.float32 else a, variables)
        ms = {k: v for k, v in v64.items() if k != 'params'}

        def loss_fn(params):
            losses, _, _ = fmodel.forward_train(
                {'params': params, **ms},
                jnp.asarray(img.transpose(0, 2, 3, 1)), jnp.asarray(gt),
                rngs={'dropout': jax.random.PRNGKey(0)})
            return parse_losses(losses)[0]

        fval, grads = jax.value_and_grad(loss_fn)(v64['params'])
        fval = float(fval)
        grads = jax.tree.map(np.asarray, grads)
    # rtol 1e-6, not 1e-9: the CE loss path keeps a deterministic
    # fp32 island (measured residue ~1.1e-7 relative)
    np.testing.assert_allclose(fval, float(loss.detach()), rtol=1e-6)
    flat = {'.'.join(k): np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(grads).items()}
    tv, fv = [], []
    for tk, tg in tgrads.items():
        comps = _translate_base(tk).split('.')
        if tk.endswith('weight'):
            if tg.ndim >= 2:
                base = '.'.join(comps[:-1])
                cands = [base + '.kernel']
                if base.endswith('downsample.bn'):
                    # avg_down layout: torch downsample.1 is the conv
                    cands.append(base[:-2] + 'conv.kernel')
            else:
                cands = ['.'.join(comps[:-1]) + '.scale',
                         '.'.join(comps[:-1]) + '.bn.scale',
                         '.'.join(comps)]  # PReLU slope keeps '.weight'
        elif tk.endswith('bias'):
            cands = ['.'.join(comps[:-1]) + '.bias',
                     '.'.join(comps[:-1]) + '.bn.bias']
        else:
            # direct-named params (mmcv Scale '.scale', pos embeds, ...)
            cands = ['.'.join(comps)]
        fk = next((c for c in cands if c in flat), None)
        assert fk is not None, f'no flax grad found for {tk}'
        fg = flat[fk]
        if tg.ndim == 4:
            fg = fg.transpose(3, 2, 0, 1)
        elif tg.ndim == 2:
            fg = fg.T
        if np.linalg.norm(tg) < 1e-8:
            # Analytically-zero gradient: e.g. a linear_conv BN bias is
            # a constant channel shift on a purely linear path into the
            # next block's train-mode BN, whose mean subtraction kills
            # it exactly. Both sides must agree it is ~0 (in f64 torch
            # holds <=7.5e-16; flax holds ~4e-7 from the CE path's fp32
            # island); its *direction* is roundoff and is excluded from
            # the cosine gates. 1e-6 is 250x below the smallest real
            # gradient norm observed (~1e-4).
            assert np.linalg.norm(fg) < 1e-6, \
                f'{tk}: torch grad ~0 but flax grad is not'
            continue
        cos = np.dot(tg.ravel(), fg.ravel()) / (
            np.linalg.norm(tg) * np.linalg.norm(fg) + 1e-30)
        assert cos > 0.999, f'{tk}: grad cosine {cos}'
        tv.append(tg.ravel())
        fv.append(fg.ravel())
    t, f = np.concatenate(tv), np.concatenate(fv)
    g_cos = np.dot(t, f) / (np.linalg.norm(t) * np.linalg.norm(f))
    assert g_cos > 0.9999, f'global grad cosine {g_cos}'


class TestMobileNetV2Parity:
    """MobileNetV2 through the production converter: validates the MNv2
    Sequential-conv key rules AND the tap-sum depthwise conv
    (ops/dwconv.py) forward + conv-autodiff backward against torch's
    grouped Conv2d — every InvertedResidual has one."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_mnv2(), seed=11).eval()
        fmodel = build_segmentor(_mnv2_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('mnv2'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(12).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'MNv2 stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(13).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        """Per-tensor + global gradient direction vs torch — in particular
        the depthwise kernels' grads, i.e. the tap-sum custom VJP's
        conv-expressed backward (f64 both sides, see _grad_cosine_f64)."""
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _mnv2_cfg(), variables)


def _build_torch_fast_scnn(num_classes=19):
    from torch_ref.fast_scnn import FastSCNN, SepFCNHead
    return __import__('torch_ref.heads', fromlist=['EncoderDecoder']) \
        .EncoderDecoder(FastSCNN(), SepFCNHead(128, 128, num_classes))


def _fast_scnn_cfg(num_classes=19):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='FastSCNN', norm_cfg=NORM, align_corners=False),
        decode_head=dict(
            type='DepthwiseSeparableFCNHead', in_channels=128, channels=128,
            num_classes=num_classes, in_index=-1, dropout_ratio=0.0,
            norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestFastSCNNParity:
    """Fast-SCNN + DepthwiseSeparableFCNHead through the production
    converter. Pins the reference details this framework initially got
    wrong: LTD first-conv padding 0 (mmcv default), the GFE 1x1 out conv,
    the FFM being three plain 1x1 ConvModules (ref fast_scnn.py:213-230),
    sep-FCN num_convs=2 + conv_cat, and the ConvModule act_cfg=None ->
    identity contract (ffm_conv_lower/higher)."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_fast_scnn(), seed=21).eval()
        fmodel = build_segmentor(_fast_scnn_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('fscnn'),
                             (1, 128, 128, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(22).randn(2, 3, 128, 128).astype(
            np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            assert f.shape == t.shape, \
                f'stage {s}: {f.shape} vs {t.shape} (padding contract)'
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'FastSCNN stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(23).randn(2, 3, 128, 128).astype(
            np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _fast_scnn_cfg(), variables, seed=24,
                         img_hw=128)


def _build_torch_cgnet(num_classes=19):
    from torch_ref.cgnet import CGNet
    from torch_ref.heads import EncoderDecoder, FCNHead
    return EncoderDecoder(CGNet(), FCNHead(256, 64, num_classes,
                                           in_index=2))


def _cgnet_cfg(num_classes=19):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='CGNet', norm_cfg=NORM),
        decode_head=dict(
            type='FCNHead', in_channels=256, channels=64, num_convs=1,
            concat_input=False, num_classes=num_classes, in_index=2,
            dropout_ratio=0.0, norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestCGNetParity:
    """CGNet through the production converter. Pins the reference details
    this framework initially got wrong: learnable per-channel PReLU (was a
    fixed LeakyReLU 0.01), the stage-output concats that re-inject the
    stage's first downsampling block (stage1 = cat[x, down1, inp_4x] ->
    131 ch, stage2 = cat[down2, x] -> 256 ch, ref cgnet.py:313-334), the
    chained-3x3 input injection (was a single 5x5), and the bias-free
    bottleneck conv."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_cgnet(), seed=31).eval()
        fmodel = build_segmentor(_cgnet_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('cgnet'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(32).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            assert f.shape == t.shape, \
                f'stage {s}: {f.shape} vs {t.shape} (concat contract)'
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'CGNet stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(33).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _cgnet_cfg(), variables, seed=34)


_HRNET_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(2,), num_channels=(32,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(2, 2), num_channels=(16, 32)),
    stage3=dict(num_modules=2, num_branches=3, block='BASIC',
                num_blocks=(2, 2, 2), num_channels=(16, 32, 64)),
    stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                num_blocks=(2, 2, 2, 2), num_channels=(16, 32, 64, 128)))


def _build_torch_hrnet(num_classes=19):
    from torch_ref.heads import EncoderDecoder, FCNHead
    from torch_ref.hrnet import HRNet
    return EncoderDecoder(HRNet(_HRNET_EXTRA),
                          FCNHead(128, 64, num_classes, in_index=3))


def _hrnet_cfg(num_classes=19):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='HRNet', extra=_HRNET_EXTRA, norm_cfg=NORM),
        decode_head=dict(
            type='FCNHead', in_channels=128, channels=64, num_convs=1,
            concat_input=False, num_classes=num_classes, in_index=3,
            dropout_ratio=0.0, norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestHRNetParity:
    """HRNet (w18-shaped, all structural paths: Bottleneck stage 1,
    channel-adapting transition, new-branch downsample chains, 4-branch
    fuse with multi-step up/downsampling, repeated modules) through the
    production converter. Pins the fuse-tail act_cfg=None contract and
    the 'transition feeds the LAST branch' reference quirk."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_hrnet(), seed=51).eval()
        fmodel = build_segmentor(_hrnet_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('hrnet'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(52).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            assert f.shape == t.shape, \
                f'branch {s}: {f.shape} vs {t.shape}'
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'HRNet branch {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(53).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _hrnet_cfg(), variables, seed=54)


def _build_torch_mnv3(num_classes=19):
    from torch_ref.heads import EncoderDecoder
    from torch_ref.mobilenet_v3 import LRASPPHead, MobileNetV3
    return EncoderDecoder(MobileNetV3(),
                          LRASPPHead(num_classes=num_classes))


def _mnv3_cfg(num_classes=19):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='MobileNetV3', arch='large',
                      out_indices=(1, 3, 16), norm_cfg=NORM),
        decode_head=dict(
            type='LRASPPHead', in_channels=(16, 24, 960),
            in_index=(0, 1, 2), channels=128, branch_channels=(32, 64),
            input_transform='multiple_select', dropout_ratio=0.0,
            num_classes=num_classes, norm_cfg=NORM,
            act_cfg=dict(type='ReLU'), align_corners=False),
        test_cfg=dict(mode='whole'))


class TestMobileNetV3LRASPPParity:
    """MobileNetV3-large (seg-converted) + LRASPPHead through the
    production converter. Pins the reference details this framework
    initially got wrong: the dilated seg conversion (layer7/13 stride 1,
    layers 7-12 dilation 2, 13-16 dilation 4 — the old code kept the
    classification strides, so output stride was 32 instead of 8),
    layer0's asymmetric TF-SAME padding, reduction_factor, and on the
    head: bare bias-free lateral convs, the missing conv_up_input, and
    the 49x49/stride-(16,20) image-pool gate (was global mean). Input
    416 keeps the coarse feature >= 49 so the unclamped pool path runs.
    Also covers SELayer + HSwish/HSigmoid end-to-end."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_mnv3(), seed=61).eval()
        fmodel = build_segmentor(_mnv3_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('mnv3'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(62).randn(1, 3, 416, 416).astype(
            np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            assert f.shape == t.shape, \
                f'stage {s}: {f.shape} vs {t.shape} (seg-conversion os)'
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'MNv3 stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(63).randn(1, 3, 416, 416).astype(
            np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        # 128 (clamped image-pool window, mirrored in the oracle): the
        # exact >= 49 pool path is covered by the 416 forward tests;
        # 416^2 f64 autodiff is beyond the 1-core CI budget
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _mnv3_cfg(), variables, seed=64,
                         img_hw=128)


def _build_torch_dlv3p(num_classes=19, channels=64):
    from torch_ref.aspp import ASPPHead
    from torch_ref.heads import EncoderDecoder
    from torch_ref.resnet import ResNetV1c
    head = ASPPHead(2048, channels, num_classes, separable=True,
                    c1_in_channels=256, c1_channels=48)
    return EncoderDecoder(ResNetV1c(depth=50), head)


def _dlv3p_cfg(num_classes=19, channels=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=NORM,
                      contract_dilation=True),
        decode_head=dict(
            type='DepthwiseSeparableASPPHead', in_channels=2048,
            in_index=3, channels=channels, dilations=(1, 12, 24, 36),
            c1_in_channels=256, c1_channels=48, dropout_ratio=0.0,
            num_classes=num_classes, norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestDeepLabV3PlusParity:
    """DeepLabV3+ (R50-d8 + DepthwiseSeparableASPPHead) through the
    production converter. Pins the V3+ module swap this framework got
    wrong (dilated ASPP branches must be depthwise-separable, ref
    sep_aspp_head.py:10-25), the c1 low-level decoder, and the
    sep_bottleneck Sequential naming."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_dlv3p(), seed=71).eval()
        fmodel = build_segmentor(_dlv3p_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('dlv3p'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(72).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _dlv3p_cfg(), variables, seed=74)


class TestASPPHeadParity:
    """Plain ASPPHead (DeepLabV3) head-only vs the torch oracle — covers
    the non-separable dilated branches the V3+ test doesn't."""

    def test_head_logits(self, tmp_path):
        from torch_ref.aspp import ASPPHead as TASPP
        from segdistill_tpu.models.builder import build_head
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        thead = _randomize(TASPP(96, 32, 19, in_index=0), seed=81).eval()
        fhead = build_head(dict(
            type='ASPPHead', in_channels=96, in_index=0, channels=32,
            dilations=(1, 12, 24, 36), dropout_ratio=0.0, num_classes=19,
            norm_cfg=NORM, align_corners=False))
        x = np.random.RandomState(82).randn(2, 96, 16, 16).astype(
            np.float32)
        feats = [jnp.asarray(x.transpose(0, 2, 3, 1))]
        variables = fhead.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in thead.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_out = thead([torch.from_numpy(x)]).numpy()
        f_out = np.asarray(fhead.apply(nv, feats),
                           np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_out, t_out, rtol=1e-4, atol=1e-4)


def _build_torch_resnest(num_classes=19, channels=64):
    from torch_ref.heads import EncoderDecoder, PSPHead
    from torch_ref.resnest import ResNeSt
    return EncoderDecoder(ResNeSt(depth=50),
                          PSPHead(2048, channels, num_classes))


def _resnest_cfg(num_classes=19, channels=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNeSt', depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=NORM,
                      contract_dilation=True),
        decode_head=dict(
            type='PSPHead', in_channels=2048, in_index=3,
            channels=channels, pool_scales=(1, 2, 3, 6), dropout_ratio=0.0,
            num_classes=num_classes, norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestResNeStParity:
    """ResNeSt-50-d8 + PSPHead through the production converter. Pins the
    split-attention layout (radix-major channel splits, grouped radix
    conv, fc1/fc2 as 1x1 convs with the bn1 island), the avd pool
    placement (after the split-attention conv), and the V1d avg_down
    downsample key layout (pool at .0 shifts conv/bn to .1/.2)."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_resnest(), seed=91).eval()
        fmodel = build_segmentor(_resnest_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('resnest'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_backbone_stage_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(92).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'ResNeSt stage {s} diverged')

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(93).randn(2, 3, 64, 64).astype(np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _resnest_cfg(), variables, seed=94)


_UNET_VARIANTS = {
    # the reference default: every stage max-pools, every decoder
    # InterpConv-upsamples
    'default': dict(strides=(1, 1, 1, 1, 1),
                    downsamples=(True, True, True, True)),
    # stride-conv downsampling (stage 2), a no-downsample stage (1) and
    # therefore a decoder whose upsample degenerates to a plain 1x1
    # ConvModule (ref up_conv_block.py:76-92)
    'strided': dict(strides=(1, 1, 2, 1, 1),
                    downsamples=(False, True, True, True)),
}


def _build_torch_unet(variant, num_classes=19, base=16):
    from torch_ref.heads import EncoderDecoder, FCNHead
    from torch_ref.unet import UNet
    head = FCNHead(base, 32, num_classes, in_index=4)
    return EncoderDecoder(UNet(base_channels=base,
                               **_UNET_VARIANTS[variant]), head)


def _unet_cfg(variant, num_classes=19, base=16):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='UNet', base_channels=base, norm_cfg=NORM,
                      **_UNET_VARIANTS[variant]),
        decode_head=dict(
            type='FCNHead', in_channels=base, channels=32, num_convs=1,
            concat_input=False, num_classes=num_classes, in_index=4,
            dropout_ratio=0.0, norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestUNetParity:
    """UNet-S5 through the production converter, two structural variants.
    Pins the BasicConvBlock first-conv contract (stride lives there,
    dilation is always 1 on it), the MaxPool-vs-stride-conv encoder
    split, the InterpConv upsample-then-1x1 order, and the degenerate
    no-upsample decoder ConvModule."""

    @pytest.fixture(scope='class', params=list(_UNET_VARIANTS))
    def setup(self, request, tmp_path_factory):
        variant = request.param
        tmodel = _randomize(_build_torch_unet(variant), seed=101).eval()
        fmodel = build_segmentor(_unet_cfg(variant))
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp(f'unet_{variant}'),
                             (1, 64, 64, 3))
        return variant, tmodel, fmodel, variables

    def test_stage_and_logit_parity(self, setup):
        variant, tmodel, fmodel, variables = setup
        x = np.random.RandomState(102).randn(2, 3, 64, 64).astype(
            np.float32)
        with torch.no_grad():
            t_outs = tmodel.backbone(torch.from_numpy(x))
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        f_outs = fmodel.net.apply(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
            method=fmodel.net.extract_feat)
        for s, (t, f) in enumerate(zip(t_outs, f_outs)):
            t = t.numpy()
            f = np.asarray(f, np.float32).transpose(0, 3, 1, 2)
            assert f.shape == t.shape, \
                f'[{variant}] stage {s}: {f.shape} vs {t.shape}'
            np.testing.assert_allclose(
                f, t, rtol=1e-4, atol=1e-4,
                err_msg=f'[{variant}] UNet stage {s} diverged')
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        variant, tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _unet_cfg(variant), variables, seed=104)


def _build_torch_resnext(num_classes=19, channels=64):
    from torch_ref.heads import EncoderDecoder, FCNHead
    from torch_ref.resnet import ResNeXt
    return EncoderDecoder(ResNeXt(depth=50),
                          FCNHead(2048, channels, num_classes, in_index=3))


def _resnext_cfg(num_classes=19, channels=64):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNeXt', depth=50, groups=32, base_width=4,
                      num_stages=4, out_indices=(0, 1, 2, 3),
                      dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1),
                      norm_cfg=NORM, contract_dilation=True,
                      deep_stem=True),
        decode_head=dict(
            type='FCNHead', in_channels=2048, in_index=3,
            channels=channels, num_convs=1, concat_input=False,
            dropout_ratio=0.0, num_classes=num_classes, norm_cfg=NORM,
            align_corners=False),
        test_cfg=dict(mode='whole'))


class TestResNeXtParity:
    """ResNeXt-50-32x4d-d8 through the production converter: grouped
    bottleneck width = floor(planes*base_width/base_channels)*groups
    (floor BEFORE the groups multiply, ref resnext.py:27-31)."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_resnext(), seed=111).eval()
        fmodel = build_segmentor(_resnext_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('resnext'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(112).randn(2, 3, 64, 64).astype(
            np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _resnext_cfg(), variables, seed=114)


def _build_torch_ocrnet(num_classes=19):
    from torch_ref.heads import FCNHead
    from torch_ref.ocr import CascadeEncoderDecoder, OCRHead
    from torch_ref.resnet import ResNetV1c
    return CascadeEncoderDecoder(
        ResNetV1c(depth=50),
        [FCNHead(1024, 64, num_classes, in_index=2),
         OCRHead(2048, 64, 32, num_classes, in_index=3)])


def _ocrnet_cfg(num_classes=19):
    return dict(
        type='CascadeEncoderDecoder', num_stages=2,
        backbone=dict(type='ResNetV1c', depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=NORM,
                      contract_dilation=True),
        decode_head=[
            dict(type='FCNHead', in_channels=1024, in_index=2, channels=64,
                 num_convs=1, concat_input=False, dropout_ratio=0.0,
                 num_classes=num_classes, norm_cfg=NORM,
                 align_corners=False),
            dict(type='OCRHead', in_channels=2048, in_index=3, channels=64,
                 ocr_channels=32, dropout_ratio=0.0,
                 num_classes=num_classes, norm_cfg=NORM,
                 align_corners=False)],
        test_cfg=dict(mode='whole'))


class TestOCRNetParity:
    """OCRNet (R50-d8 cascade: FCN stage 0 -> OCR stage 1) through the
    production converter. Pins the cascade composition (stage-1 consumes
    stage-0 logits), the spatial-gather softmax-over-pixels, the
    ObjectAttentionBlock projection stack (2 normed key/query convs,
    matmul_norm) and its inner bottleneck ('conv_bn'), and the
    SelfAttentionBlock projection key layouts."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_ocrnet(), seed=121).eval()
        fmodel = build_segmentor(_ocrnet_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('ocrnet'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(122).randn(2, 3, 64, 64).astype(
            np.float32)
        with torch.no_grad():
            t_logits = tmodel(torch.from_numpy(x)).numpy()
        outs = fmodel.net.apply(variables,
                                jnp.asarray(x.transpose(0, 2, 3, 1)),
                                train=False, with_aux=False)
        f_logits = np.asarray(outs['decode'], np.float32).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(f_logits, t_logits, rtol=1e-4, atol=1e-4)

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _ocrnet_cfg(), variables, seed=124)


class TestAttnHeadsParity:
    """NL / GC / DNL heads head-only vs torch oracles: the
    FCNHead(num_convs=2)+conv_cat skeleton (the old heads fused convs_1
    with the concat, dropping a conv), mmcv NonLocal2d's normed
    conv_out + in-block residual, DNL's temperature on the PAIRWISE
    logits (was applied to the unary instead), and ContextBlock's
    conv/LN/ReLU/conv transform under the reference's key layout."""

    @pytest.mark.parametrize('name', ['NLHead', 'GCHead', 'DNLHead',
                                      'EMAHead', 'EncHead', 'APCHead',
                                      'DMHead'])
    def test_head_logits(self, name, tmp_path):
        import torch_ref.attn_heads as oracles
        from segdistill_tpu.models.builder import build_head
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        extra_t, extra_f = {}, {}
        if name == 'EMAHead':
            extra_t = dict(ema_channels=48, num_bases=8, num_stages=3)
            extra_f = dict(ema_channels=48, num_bases=8, num_stages=3)
        elif name == 'EncHead':
            extra_t = dict(num_codes=8)
            extra_f = dict(num_codes=8, use_se_loss=True,
                           input_transform='multiple_select')
        elif name == 'APCHead':
            extra_t = dict(pool_scales=(1, 2, 3))
            extra_f = dict(pool_scales=(1, 2, 3))
        elif name == 'DMHead':
            extra_t = dict(filter_sizes=(1, 3, 5))
            extra_f = dict(filter_sizes=(1, 3, 5))
        thead = _randomize(getattr(oracles, name)(96, 32, **extra_t,
                                                  num_classes=19,
                                                  in_index=0),
                           seed=131).eval()
        in_cfg = dict(in_channels=96, in_index=0)
        if name == 'EncHead':  # multiple_select expects lists
            in_cfg = dict(in_channels=[96], in_index=[0])
        fhead = build_head(dict(
            type=name, **in_cfg, channels=32, **extra_f,
            dropout_ratio=0.0, num_classes=19, norm_cfg=NORM,
            align_corners=False))
        x = np.random.RandomState(132).randn(2, 96, 16, 16).astype(
            np.float32)
        feats = [jnp.asarray(x.transpose(0, 2, 3, 1))]
        variables = fhead.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in thead.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_out = thead([torch.from_numpy(x)])
        f_out = fhead.apply(nv, feats)
        if name == 'EncHead':
            np.testing.assert_allclose(
                np.asarray(f_out[1], np.float32), t_out[1].numpy(),
                rtol=1e-4, atol=1e-4, err_msg='EncHead se diverged')
            t_out, f_out = t_out[0], f_out[0]
        else:
            t_out = t_out
        t_out = t_out.numpy() if hasattr(t_out, 'numpy') else t_out
        f_out = np.asarray(f_out, np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_out, t_out, rtol=1e-4, atol=1e-4,
                                   err_msg=f'{name} diverged')


class TestCCPSAHeadsParity:
    """CCHead / PSAHead state-dict round-trips (VERDICT r3 weak #4): the
    reference heads wrap compiled mmcv CUDA ops, so the torch twins in
    torch_ref/cc_psa.py re-derive the documented op semantics with the
    reference's exact state-dict layout; a random-init state dict goes
    through the production converter and must reproduce logits."""

    def _roundtrip(self, thead, fhead, in_ch, seed):
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        thead = _randomize(thead, seed=seed).eval()
        x = np.random.RandomState(seed + 1).randn(
            2, in_ch, 16, 16).astype(np.float32)
        feats = [jnp.asarray(x.transpose(0, 2, 3, 1))]
        variables = fhead.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in thead.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_out = thead([torch.from_numpy(x)]).numpy()
        f_out = np.asarray(fhead.apply(nv, feats),
                           np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_out, t_out, rtol=1e-4, atol=1e-4)

    def test_cc_head(self, ):
        from torch_ref.cc_psa import CCHead as TorchCCHead
        from segdistill_tpu.models.builder import build_head
        thead = TorchCCHead(96, 32, num_classes=19, recurrence=2,
                            in_index=0)
        # gamma is zero-init (attention path silent) — make it bite
        with torch.no_grad():
            thead.cca.gamma.fill_(0.5)
        fhead = build_head(dict(
            type='CCHead', in_channels=96, in_index=0, channels=32,
            recurrence=2, dropout_ratio=0.0, num_classes=19, norm_cfg=NORM,
            align_corners=False))
        self._roundtrip(thead, fhead, 96, seed=171)

    @pytest.mark.parametrize('psa_type', ['bi-direction', 'collect'])
    def test_psa_head(self, psa_type):
        from torch_ref.cc_psa import PSAHead as TorchPSAHead
        from segdistill_tpu.models.builder import build_head
        thead = TorchPSAHead(64, 32, num_classes=19, mask_size=(9, 9),
                             psa_type=psa_type, shrink_factor=2,
                             in_index=0)
        fhead = build_head(dict(
            type='PSAHead', in_channels=64, in_index=0, channels=32,
            mask_size=(9, 9), psa_type=psa_type, compact=False,
            shrink_factor=2, normalization_factor=1.0, psa_softmax=True,
            dropout_ratio=0.0, num_classes=19, norm_cfg=NORM,
            align_corners=False))
        self._roundtrip(thead, fhead, 64, seed=173)


def _build_torch_danet(num_classes=19):
    from torch_ref.attn_heads import DAEncoderDecoder, DAHead
    from torch_ref.resnet import ResNetV1c
    return DAEncoderDecoder(ResNetV1c(depth=50),
                            DAHead(2048, 64, 16, num_classes, in_index=3))


def _danet_cfg(num_classes=19):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=NORM,
                      contract_dilation=True),
        decode_head=dict(
            type='DAHead', in_channels=2048, in_index=3, channels=64,
            pam_channels=16, dropout_ratio=0.0, num_classes=num_classes,
            norm_cfg=NORM, align_corners=False),
        test_cfg=dict(mode='whole'))


class TestDANetParity:
    """DANet (R50-d8 + DAHead) through the production converter. Pins the
    PAM projection width (pam_channels, NOT further //8-reduced), the
    mmcv Scale gammas, the triple-output head contract (pam_cam/pam/cam
    each with its own conv_seg and CE loss), and CAM's max-subtracted
    channel affinity."""

    @pytest.fixture(scope='class')
    def setup(self, tmp_path_factory):
        tmodel = _randomize(_build_torch_danet(), seed=141).eval()
        fmodel = build_segmentor(_danet_cfg())
        variables = _convert(fmodel, tmodel,
                             tmp_path_factory.mktemp('danet'),
                             (1, 64, 64, 3))
        return tmodel, fmodel, variables

    def test_logit_parity(self, setup):
        tmodel, fmodel, variables = setup
        x = np.random.RandomState(142).randn(2, 3, 64, 64).astype(
            np.float32)
        with torch.no_grad():
            t_outs = tmodel.decode_head(tmodel.backbone(
                torch.from_numpy(x)))
        f_outs = fmodel.net.apply(variables,
                                  jnp.asarray(x.transpose(0, 2, 3, 1)),
                                  train=False, with_aux=False)['decode']
        for name, t, f in zip(('pam_cam', 'pam', 'cam'), t_outs, f_outs):
            np.testing.assert_allclose(
                np.asarray(f, np.float32).transpose(0, 3, 1, 2),
                t.numpy(), rtol=1e-4, atol=1e-4,
                err_msg=f'DA {name} logits diverged')

    def test_step0_gradient_cosine_f64(self, setup):
        tmodel, fmodel, variables = setup
        _grad_cosine_f64(tmodel, _danet_cfg(), variables, seed=144)


class TestANNHeadParity:
    """ANNHead head-only vs the torch oracle: AFNB/APNB blocks own their
    cat+bottleneck (the old head ADDED the fusion context to high and
    dropped both block bottlenecks), key/query projections are normed
    ConvModules with the head act, and key/value are pyramid-pooled
    AFTER projection (pooling does not commute with the projection
    ReLU)."""

    def test_head_logits(self, tmp_path):
        from torch_ref.attn_heads import ANNHead as TANN
        from segdistill_tpu.models.builder import build_head
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        thead = _randomize(TANN((64, 96), 32, 16, 19), seed=151).eval()
        fhead = build_head(dict(
            type='ANNHead', in_channels=[64, 96], in_index=[0, 1],
            input_transform='multiple_select', channels=32,
            project_channels=16, dropout_ratio=0.0, num_classes=19,
            norm_cfg=NORM, align_corners=False))
        rs = np.random.RandomState(152)
        low = rs.randn(2, 64, 16, 16).astype(np.float32)
        high = rs.randn(2, 96, 16, 16).astype(np.float32)
        feats = [jnp.asarray(low.transpose(0, 2, 3, 1)),
                 jnp.asarray(high.transpose(0, 2, 3, 1))]
        variables = fhead.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in thead.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_out = thead([torch.from_numpy(low),
                           torch.from_numpy(high)]).numpy()
        f_out = np.asarray(fhead.apply(nv, feats),
                           np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_out, t_out, rtol=1e-4, atol=1e-4)


class TestFPNParity:
    """FPN neck + FPNHead head-only vs torch oracles: the neck's act-free
    biased laterals/fpn convs and nearest top-down fusion; the head's
    interleaved conv/upsample scale-head Sequential key layout."""

    def test_neck(self, tmp_path):
        from torch_ref.fpn import FPN as TFPN
        from segdistill_tpu.models.builder import build_neck
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        tneck = _randomize(TFPN([32, 64, 96, 128], 48, 4),
                           seed=161).eval()
        fneck = build_neck(dict(type='FPN',
                                in_channels=[32, 64, 96, 128],
                                out_channels=48, num_outs=4))
        rs = np.random.RandomState(162)
        xs = [rs.randn(2, c, s, s).astype(np.float32)
              for c, s in zip((32, 64, 96, 128), (32, 16, 8, 4))]
        feats = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
        variables = fneck.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in tneck.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_outs = tneck([torch.from_numpy(x) for x in xs])
        f_outs = fneck.apply(nv, feats)
        for i, (t, f) in enumerate(zip(t_outs, f_outs)):
            np.testing.assert_allclose(
                np.asarray(f, np.float32).transpose(0, 3, 1, 2),
                t.numpy(), rtol=1e-4, atol=1e-5,
                err_msg=f'FPN neck level {i} diverged')

    def test_head(self, tmp_path):
        from torch_ref.fpn import FPNHead as TFPNHead
        from segdistill_tpu.models.builder import build_head
        from segdistill_tpu.convert.torch_loader import translate_state_dict
        thead = _randomize(TFPNHead([48] * 4, 32, 19), seed=163).eval()
        fhead = build_head(dict(
            type='FPNHead', in_channels=[48] * 4, in_index=[0, 1, 2, 3],
            feature_strides=(4, 8, 16, 32),
            input_transform='multiple_select', channels=32,
            dropout_ratio=0.0, num_classes=19, norm_cfg=NORM,
            align_corners=False))
        rs = np.random.RandomState(164)
        xs = [rs.randn(2, 48, s, s).astype(np.float32)
              for s in (32, 16, 8, 4)]
        feats = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
        variables = fhead.init({'params': jax.random.PRNGKey(0)}, feats)
        sd = {k: t.numpy() for k, t in thead.state_dict().items()}
        nv, matched, missing, unexpected = translate_state_dict(
            sd, variables)
        assert not missing and not unexpected, (missing, unexpected)
        with torch.no_grad():
            t_out = thead([torch.from_numpy(x) for x in xs]).numpy()
        f_out = np.asarray(fhead.apply(nv, feats),
                           np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f_out, t_out, rtol=1e-4, atol=1e-4)
