"""The SGD and Adam optimizers and the Cityscapes dataset of the port against
the JAX package, on the CPU.

SGD and Adam are ``torch.optim.SGD`` and ``torch.optim.Adam``, as mmcv
builds them for the reference: the weight decay is added to the gradient
before the momentum (or the moments). The JAX package adds it after them,
decoupled (``optax.trace`` / ``scale_by_adam``, then ``+ wd * p``): a
deliberate divergence. So: without weight decay the port's trajectory is
the JAX chain's (two param groups, lr_mult 1 and 10, the schedule's poly
LR), to 1e-6 relative; with it, the port's is torch's coupled update as a
numpy statement spells it, and the JAX chain's the decoupled one, ~10x
weaker at momentum 0.9 once the momentum has built up.
"""

import math
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.datasets import CityscapesDataset as JaxCityscapes
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.datasets import CityscapesDataset, build_dataset
from segdistill_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                         set_lr)

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)
MAX_ITERS = 40000
HEAD_10X = dict(custom_keys={'head': dict(lr_mult=10.),
                             'norm': dict(decay_mult=0.)})


class Net(torch.nn.Module):
    """Three tensors under the names the paramwise keys match:
    ``backbone.w`` (lr 1x), ``decode_head.w`` (lr 10x) and
    ``backbone.norm.w`` (decay 0)."""

    def __init__(self, values):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.norm = torch.nn.Module()
        self.decode_head = torch.nn.Module()
        self.backbone.w = torch.nn.Parameter(torch.tensor(values[0]))
        self.backbone.norm.w = torch.nn.Parameter(torch.tensor(values[1]))
        self.decode_head.w = torch.nn.Parameter(torch.tensor(values[2]))

    def named(self):
        return {'backbone.w': self.backbone.w,
                'backbone.norm.w': self.backbone.norm.w,
                'decode_head.w': self.decode_head.w}


def _values(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(4).astype(np.float64) for _ in range(3)]


def _grads(step, seed=1):
    rng = np.random.RandomState(seed + step)
    return [rng.randn(4) for _ in range(3)]


def _port_run(cfg, steps, values, grads=_grads):
    net = Net(values)
    opt = build_optimizer(cfg, net)
    schedule = build_lr_schedule(LR_CONFIG, cfg['lr'], MAX_ITERS)
    for i in range(steps):
        set_lr(opt, schedule(i))
        for p, g in zip(net.named().values(), grads(i)):
            p.grad = torch.tensor(g)
        opt.step()
    return [p.detach().numpy() for p in net.named().values()]


def _jax_run(cfg, steps, values, grads=_grads):
    import optax
    params = {'backbone': {'w': values[0], 'norm': {'w': values[1]}},
              'decode_head': {'w': values[2]}}
    params = {k: _as_jnp(v) for k, v in params.items()}
    tx = jax_build_optimizer(cfg, params, jax_lr_schedule(
        LR_CONFIG, cfg['lr'], MAX_ITERS))
    state = tx.init(params)
    for i in range(steps):
        g = grads(i)
        g = {'backbone': {'w': g[0], 'norm': {'w': g[1]}},
             'decode_head': {'w': g[2]}}
        updates, state = tx.update(_as_jnp(g), state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(params['backbone']['w']),
            np.asarray(params['backbone']['norm']['w']),
            np.asarray(params['decode_head']['w'])]


def _as_jnp(tree):
    if isinstance(tree, dict):
        return {k: _as_jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32)


def _numpy_sgd(values, steps, lr, momentum, wd, coupled, nesterov=False,
               grads=_grads):
    """SGD with paramwise (lr_mult, decay_mult) (1, 1), (1, 0), (10, 1):
    the decay ``wd * decay_mult * p`` added to the gradient before the
    momentum (torch, ``coupled``) or to the update after it (the JAX
    chain)."""
    schedule = build_lr_schedule(LR_CONFIG, lr, MAX_ITERS)
    mults = [(1.0, 1.0), (1.0, 0.0), (10.0, 1.0)]
    ps = [v.copy() for v in values]
    bufs = [None] * 3
    for i in range(steps):
        for j, ((lm, dm), g) in enumerate(zip(mults, grads(i))):
            d = g + wd * dm * ps[j] if coupled else g
            bufs[j] = d if bufs[j] is None else momentum * bufs[j] + d
            step = d + momentum * bufs[j] if nesterov else bufs[j]
            if not coupled:
                step = step + wd * dm * ps[j]
            ps[j] = ps[j] - schedule(i) * lm * step
    return ps


def _paramwise():
    return {'custom_keys': {k: dict(v) for k, v in
                            HEAD_10X['custom_keys'].items()}}


def _sgd(wd, nesterov=False):
    return dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=wd,
                nesterov=nesterov, paramwise_cfg=_paramwise())


@pytest.mark.parametrize('nesterov', [False, True])
def test_sgd_without_decay_is_the_jax_chain(nesterov):
    """Five steps, two lr groups, the poly schedule: the port's SGD, the
    JAX package's optax chain (fp32) and the numpy statement agree."""
    values = _values()
    cfg = _sgd(0.0, nesterov)
    got = _port_run(cfg, 5, values)
    want = _jax_run(cfg, 5, values)
    spec = _numpy_sgd(values, 5, 0.01, 0.9, 0.0, True, nesterov)
    for g, w, s in zip(got, want, spec):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, s, rtol=1e-12, atol=1e-12)
    assert not np.allclose(got[0], values[0])


def test_sgd_with_decay_is_torchs_coupled_update():
    """With weight decay 0.05 (decay_mult 0 on the norm): the port is
    torch's update, the decay inside the momentum; the JAX chain is the
    decoupled one, and the two differ."""
    values = _values()
    cfg = _sgd(0.05)
    got = _port_run(cfg, 5, values)
    coupled = _numpy_sgd(values, 5, 0.01, 0.9, 0.05, True)
    decoupled = _numpy_sgd(values, 5, 0.01, 0.9, 0.05, False)
    want_jax = _jax_run(cfg, 5, values)
    for g, c, d, j in zip(got, coupled, decoupled, want_jax):
        np.testing.assert_allclose(g, c, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(j, d, rtol=1e-6, atol=1e-6)
    # the norm's decay_mult 0: no decay either way
    np.testing.assert_allclose(got[1], want_jax[1], rtol=1e-6, atol=1e-6)
    assert np.abs(got[0] - want_jax[0]).max() > 1e-4


def test_the_jax_decay_is_about_10x_weaker_at_momentum_09():
    """p = [1, -2, 0.5], lr 0.01, momentum 0.9, three fixed gradients:
    without decay the two agree; with weight decay 0.05 they part. With
    no gradient, once the momentum has built up, torch's decay shrinks a
    weight ~1 / (1 - momentum) = 10x faster than the decoupled one."""
    p0 = np.array([1.0, -2.0, 0.5])
    fixed = [np.array([0.3, -0.1, 0.2]), np.array([0.1, 0.4, -0.3]),
             np.array([-0.2, 0.2, 0.1])]

    def run(wd, coupled, steps, grads):
        net = torch.nn.Linear(3, 1, bias=False).double()
        with torch.no_grad():
            net.weight.copy_(torch.tensor(p0[None]))
        if coupled:
            opt = build_optimizer(dict(type='SGD', lr=0.01, momentum=0.9,
                                       weight_decay=wd), net)
            for i in range(steps):
                net.weight.grad = torch.tensor(grads(i)[None])
                opt.step()
            return net.weight.detach().numpy()[0].astype(np.float64)
        import optax
        params = {'w': jnp.asarray(p0, jnp.float32)}
        tx = jax_build_optimizer(dict(type='SGD', lr=0.01, momentum=0.9,
                                      weight_decay=wd), params)
        state = tx.init(params)
        for i in range(steps):
            upd, state = tx.update({'w': jnp.asarray(grads(i), jnp.float32)},
                                   state, params)
            params = optax.apply_updates(params, upd)
        return np.asarray(params['w'], np.float64)

    three = lambda i: fixed[i]  # noqa: E731
    np.testing.assert_allclose(run(0.0, True, 3, three),
                               run(0.0, False, 3, three), rtol=1e-6)
    assert np.abs(run(0.05, True, 3, three)
                  - run(0.05, False, 3, three)).max() > 1e-3
    zero = lambda i: np.zeros(3)  # noqa: E731
    steps = 200
    torch_rate = -np.log(run(0.05, True, steps, zero) / p0) / steps
    jax_rate = -np.log(run(0.05, False, steps, zero) / p0) / steps
    ratio = torch_rate / jax_rate
    assert np.all((ratio > 9.0) & (ratio < 11.0)), ratio


def test_adam_is_torch_adam():
    """Adam without decay is the JAX chain's update; with decay it is
    ``torch.optim.Adam`` (the decay in the gradient), not AdamW."""
    values = _values(3)
    cfg = dict(type='Adam', lr=0.001, betas=(0.9, 0.999), weight_decay=0.0,
               paramwise_cfg=_paramwise())
    got = _port_run(cfg, 4, values)
    want = _jax_run(cfg, 4, values)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    opt = build_optimizer(dict(cfg, weight_decay=0.01), Net(values))
    assert type(opt) is torch.optim.Adam
    assert sorted(g['weight_decay'] for g in opt.param_groups) == [0.0, 0.01,
                                                                   0.01]
    assert type(build_optimizer(dict(cfg, type='AdamW'), Net(values))) \
        is torch.optim.AdamW
    with pytest.raises(NotImplementedError, match='RMSprop'):
        build_optimizer(dict(cfg, type='RMSprop'), Net(values))


def test_schedule_40k_poly_lr():
    """The schedules' poly LR (power 0.9, min_lr 1e-4, no warmup) is the
    JAX package's, and the SGD config of ``schedule_40k.py`` builds."""
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs', 'extra', 'pspnet_r50_cityscapes_slide.py'))
    assert cfg.optimizer['type'] == 'SGD'
    port = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                             cfg.runner['max_iters'])
    jax = jax_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                          cfg.runner['max_iters'])
    for step in (0, 1, 1000, 20000, 39999, 40000):
        assert port(step) == pytest.approx(float(jax(step)), rel=1e-6)
    assert port(40000) == pytest.approx(1e-4)
    opt = build_optimizer(cfg.optimizer, Net(_values()))
    assert type(opt) is torch.optim.SGD
    assert opt.defaults['momentum'] == 0.9
    assert {g['weight_decay'] for g in opt.param_groups} == {0.0005}
    assert math.isclose(opt.param_groups[0]['lr'], 0.01)


def _write_cityscapes(root):
    rng = np.random.RandomState(0)
    for split, cities in (('train', ('aachen', 'bochum')),
                          ('val', ('frankfurt',))):
        for city in cities:
            for k in range(2):
                stem = f'{city}_{k:06d}_000019'
                img_dir = os.path.join(root, 'leftImg8bit', split, city)
                ann_dir = os.path.join(root, 'gtFine', split, city)
                os.makedirs(img_dir, exist_ok=True)
                os.makedirs(ann_dir, exist_ok=True)
                cv2.imwrite(os.path.join(img_dir, f'{stem}_leftImg8bit.png'),
                            rng.randint(0, 256, (16, 32, 3), np.uint8))
                label = rng.randint(0, 19, (16, 32)).astype(np.uint8)
                label[:2] = 255
                cv2.imwrite(os.path.join(
                    ann_dir, f'{stem}_gtFine_labelTrainIds.png'), label)
                # files the listing must skip
                cv2.imwrite(os.path.join(ann_dir, f'{stem}_gtFine_color.png'),
                            label)


def test_cityscapes_lists_and_converts_as_jax(tmp_path):
    """The config's train and val sets over a Cityscapes tree (one folder
    per city, other gtFine files beside the train-id maps): the same
    images, label maps and ground truth as the JAX dataset; the 19 class
    names and palette; train ids -> label ids as JAX converts them."""
    root = str(tmp_path)
    _write_cityscapes(root)
    cfg = Config.fromfile(os.path.join(
        ROOT, 'configs', 'extra', 'pspnet_r50_cityscapes_slide.py'))
    for split, n in (('train', 4), ('val', 2)):
        spec = dict(cfg.data[split], data_root=root)
        port = build_dataset(spec)
        assert isinstance(port, CityscapesDataset) and len(port) == n
        spec.pop('type')
        jax_set = JaxCityscapes(**spec)
        assert port.img_infos == jax_set.img_infos
        for a, b in zip(port.get_gt_seg_maps(), jax_set.get_gt_seg_maps()):
            np.testing.assert_array_equal(a, b)
    assert port.CLASSES == JaxCityscapes.CLASSES and len(port.CLASSES) == 19
    assert np.array_equal(np.asarray(port.PALETTE),
                          np.asarray(JaxCityscapes.PALETTE))
    result = np.random.RandomState(1).randint(0, 21, (5, 7))
    np.testing.assert_array_equal(
        CityscapesDataset._convert_to_label_id(result),
        JaxCityscapes._convert_to_label_id(result))
    sample = port[0]
    assert sample['img'][0].shape[:2] == (1024, 2048)
