"""The port's CGD distillation train step against the JAX package, fp32 on
the CPU, and the repairs the training path needed.

A small SDModule (MiT-b0 student and teacher, 19 classes, head embed 64,
64x64 images, batch 2, dropout and drop-path 0 on both sides: JAX's PRNG
cannot be reproduced) carries the JAX variables through
``state_dict_from_jax``. Held against JAX: the loss dict and the student's
gradients at steps 1 and 1000 (the JAX channel permutation injected), and
a 3-step trajectory of ``build_train_step`` with AdamW paramwise and a poly
LR with 2 warmup iterations: losses, parameters and BN statistics, at the
fixtures' ``RTOL, ATOL``. BN's running variance follows torch (unbiased
batch variance) where flax keeps the biased one; the test holds the two to
that N/(N-1) relation.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.engine import build_train_step as jax_train_step
from segdistill_tpu.engine import create_train_state
from segdistill_tpu.engine.optimizer import (
    paramwise_labels as jax_paramwise_labels)
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu.models.segmentors.sd_module import _init_adapters
from segdistill_tpu_torch.apis import init_segmentor, init_segmentor_state
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.distill import ChannelAdapter
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step,
                                         paramwise_labels)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import parse_losses
from segdistill_tpu_torch.models.utils import DropPath, Dropout

from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)

CGD = dict(student_layer='decode_head.linear_pred',
           teacher_layer='decode_head.linear_pred', loss_name='CGDLoss',
           loss_config={})
OPTIMIZER = dict(type='AdamW', lr=6e-5, betas=(0.9, 0.999), weight_decay=0.01,
                 paramwise_cfg=dict(custom_keys={
                     'pos_block': dict(decay_mult=0.),
                     'norm': dict(decay_mult=0.),
                     'head': dict(lr_mult=10.)}))
LR_CONFIG = dict(policy='poly', warmup='linear', warmup_iters=2,
                 warmup_ratio=0.1, power=1.0, min_lr=0.0)
MAX_ITERS = 100
CONFIG = 'configs/segformer/segformer_b0_512x512_ade_160k.py'

# Parameters whose gradient is 0 in exact arithmetic: the head embeddings'
# biases and the last stage norm's bias only add per-channel constants that
# reach the head's train-mode BN, which removes them. Each side holds float
# noise there, which Adam would turn into steps of ~lr in random directions
# (and, through the BN's running mean, into other numbers): the trajectory
# freezes them on both sides (zero lr and decay), which changes no gradient.
FROZEN = {'jax': ['linear_c1.bias', 'linear_c2.bias', 'linear_c3.bias',
                  'linear_c4.bias', 'norm4.bias'],
          'port': ['linear_c1.proj.bias', 'linear_c2.proj.bias',
                   'linear_c3.proj.bias', 'linear_c4.proj.bias',
                   'norm4.bias']}


def trajectory_optimizer(side):
    cfg = copy.deepcopy(OPTIMIZER)
    cfg['paramwise_cfg']['custom_keys'].update(
        {k: dict(lr_mult=0., decay_mult=0.) for k in FROZEN[side]})
    return cfg


def key_bias_mask(name, value):
    """The key half of a ``kv`` bias, which shifts every score of a query
    by the same amount: the softmax removes it, so its gradient is noise
    and its value changes no output."""
    mask = torch.zeros(value.shape, dtype=torch.bool)
    if re.fullmatch(r'backbone\.block\d\.\d+\.attn\.kv\.bias', name):
        mask[:value.shape[0] // 2] = True
    return mask


def sd_cfg(teacher_fused_attention=False, distillation=(CGD,)):
    return dict(
        type='SDModule',
        cfg_s=segformer_cfg(dropout_ratio=0.0),
        cfg_t=segformer_cfg(dropout_ratio=0.0,
                            fused_attention=teacher_fused_attention),
        distillation=[dict(d) for d in distillation], train_cfg={},
        test_cfg=dict(mode='whole'))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope='module')
def jax_sd():
    model = build_jax_segmentor(sd_cfg())
    sv = random_jax_variables(model.student, seed=0)
    tv = random_jax_variables(model.teacher, seed=1)
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2, 64, 64)).astype(np.int32)
    gt[0, :4] = 255
    return model, sv, tv, img, gt


def _jax_perm(model, step, rng):
    crit = model.distillation_loss.entries[0]['criterion']
    return np.asarray(crit._shuffle_idx(NUM_CLASSES, step, rng))


@pytest.fixture(scope='module')
def jax_step(jax_sd):
    """{step: (log_vars, student grads, perm)} for steps 1 and 1000, from
    one jit of the loss and its gradient."""
    model, sv, tv, img, gt = jax_sd

    @jax.jit
    def loss_and_grad(params, bstats, tvars, img, gt, step, key):
        def f(p):
            losses, _ = model.forward_train(
                {'params': p, 'batch_stats': bstats}, tvars, img, gt, step,
                rngs={'dropout': key}, shuffle_rng=key)
            total, log_vars = jax_parse(losses)
            return total, log_vars
        return jax.grad(f, has_aux=True)(params)

    key = jax.random.key(5)
    out = {}
    for step in (1, 1000):
        grads, log_vars = loss_and_grad(
            sv['params'], sv['batch_stats'], tv, jnp.asarray(img),
            jnp.asarray(gt), jnp.int32(step), key)
        out[step] = ({k: float(v) for k, v in log_vars.items()},
                     jax.tree.map(np.asarray, grads),
                     _jax_perm(model, step, key))
    return out


@pytest.fixture(scope='module')
def jax_trajectory(jax_sd):
    """Three steps of JAX's build_train_step: per step the log vars, the
    permutation it used, and the student params and BN stats after it."""
    model, sv, tv, img, gt = jax_sd
    schedule = jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    tx = jax_build_optimizer(trajectory_optimizer('jax'), sv['params'],
                             schedule)
    state = create_train_state(jax.random.key(1), sv, tx)
    step_fn = jax_train_step(model, tx, schedule, donate=False)
    steps = []
    for _ in range(3):
        step = int(state.step) + 1
        shuffle_rng = jax.random.split(jax.random.fold_in(state.rng, step))[1]
        perm = _jax_perm(model, step, shuffle_rng)
        state, log_vars = step_fn(state, tv, jnp.asarray(img),
                                  jnp.asarray(gt))
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()}, perm=perm,
            variables=jax.tree.map(np.asarray, {
                'params': state.params,
                'batch_stats': state.model_state['batch_stats']})))
    return steps


def _port_sd(jax_sd, **cfg_kw):
    _, sv, tv, _, _ = jax_sd
    model = build_segmentor(sd_cfg(**cfg_kw))
    model.load_state_dict(state_dict_from_jax({'student': sv,
                                               'teacher': tv}), strict=True)
    return model.train()


def _port_batch(jax_sd):
    _, _, _, img, gt = jax_sd
    return (torch.from_numpy(nhwc_to_nchw(img).copy()),
            torch.from_numpy(gt.astype(np.int64)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize('step', [1, 1000])
def test_loss_dict_matches_jax(jax_sd, jax_step, step):
    want, _, perm = jax_step[step]
    model = _port_sd(jax_sd)
    img, gt = _port_batch(jax_sd)
    losses = model.forward_train(img, gt, step,
                                 perm=torch.from_numpy(perm.copy()))
    _, got = parse_losses(losses)
    assert set(got) == set(want)
    assert 'loss_decode_head.linear_pred<->decode_head.linear_pred_other' \
        in got
    for k in want:
        _close(got[k].item(), want[k], k)


@pytest.mark.parametrize('step', [1, 1000])
def test_student_gradients_match_jax(jax_sd, jax_step, step):
    _, grads, perm = jax_step[step]
    model = _port_sd(jax_sd)
    img, gt = _port_batch(jax_sd)
    total, _ = parse_losses(model.forward_train(
        img, gt, step, perm=torch.from_numpy(perm.copy())))
    total.backward()
    want = state_dict_from_jax({'params': grads})
    got = {n: p.grad for n, p in model.student.named_parameters()}
    assert got.keys() == want.keys()
    # atol relative to the largest gradient: the embeddings' biases feed
    # train-mode BN, which removes them, so their true gradient is 0 and
    # both sides hold float noise there
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)
    assert all(p.grad is None for p in model.teacher.parameters())


def test_three_step_trajectory_matches_jax(jax_sd, jax_trajectory):
    model = _port_sd(jax_sd)
    teacher_before = copy.deepcopy(model.teacher.state_dict())
    optimizer = build_optimizer(trajectory_optimizer('port'), model)
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    step_fn = build_train_step(model, optimizer, schedule)
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    img, gt = _port_batch(jax_sd)
    n_bn = 2 * 16 * 16  # the head BN's batch: 2 maps at stride 4 of 64x64
    prev_t = {k: v.clone() for k, v in model.student.state_dict().items()}
    prev_j = state_dict_from_jax(
        {'params': jax_sd[1]['params'], 'batch_stats': jax_sd[1][
            'batch_stats']})
    noise_bound = 0.0
    for i, ref in enumerate(jax_trajectory):
        log_vars = step_fn(state, img, gt,
                           perm=torch.from_numpy(ref['perm'].copy()))
        # noise that Adam turns into steps of ~lr (x1 in the backbone)
        noise_bound += 2 * 2 * schedule(i)
        assert state.step == i + 1
        for k, v in ref['log_vars'].items():
            _close(float(log_vars[k]), v, f'step {i + 1} {k}')
        want = state_dict_from_jax(ref['variables'])
        got = model.student.state_dict()
        for name, w in want.items():
            if name.endswith('running_var'):
                # torch: 0.9 rv + 0.1 * unbiased; flax: 0.9 rv + 0.1 biased
                _close(got[name] - 0.9 * prev_t[name],
                       (w - 0.9 * prev_j[name]) * n_bn / (n_bn - 1),
                       f'step {i + 1} {name}')
            elif not name.endswith('num_batches_tracked'):
                noise = key_bias_mask(name, w)
                assert bool(((got[name] - w)[noise].abs()
                             <= noise_bound).all()), name
                _close(got[name][~noise], w[~noise], f'step {i + 1} {name}')
        prev_t = {k: v.clone() for k, v in got.items()}
        prev_j = want
    for name, value in model.teacher.state_dict().items():
        assert torch.equal(value, teacher_before[name]), name


def test_train_segmentor_runs_to_max_iters(jax_sd, caplog):
    """``train_segmentor`` over in-memory batches: the config's max_iters
    steps, the log hook at its interval, the same first loss as the
    step function."""
    from segdistill_tpu.config import Config
    from segdistill_tpu_torch.apis import train_segmentor
    cfg = Config(dict(optimizer=OPTIMIZER, lr_config=LR_CONFIG,
                      runner=dict(type='IterBasedRunner', max_iters=3),
                      log_config=dict(interval=2)))
    img, gt = _port_batch(jax_sd)
    batches = [{'img': img.numpy(), 'gt_semantic_seg': gt.numpy()}] * 3
    with caplog.at_level('INFO'):
        state = train_segmentor(_port_sd(jax_sd), iter(batches), cfg)
    assert state.step == 3
    logs = [r.getMessage() for r in caplog.records if 'Iter' in r.message]
    assert len(logs) == 1 and logs[0].startswith('Iter [2/3]')
    assert 'decode.loss_seg' in logs[0] and 'lr: ' in logs[0]


def test_teacher_stays_frozen(jax_sd):
    model = _port_sd(jax_sd)
    assert not any(p.requires_grad for p in model.teacher.parameters())
    assert model.train().student.training and not model.teacher.training
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert names and all(n.startswith('student.') for n in names)


def test_inference_is_the_students(jax_sd):
    model = _port_sd(jax_sd).eval()
    img, _ = _port_batch(jax_sd)
    with torch.no_grad():
        assert torch.equal(model.encode_decode(img),
                           model.student.encode_decode(img))


def test_paramwise_groups_match_jax(jax_sd):
    """'head', 'norm' and 'pos_block' hit the same parameters in the
    port's state-dict names as in the JAX paths."""
    _, sv, _, _, _ = jax_sd
    keys = OPTIMIZER['paramwise_cfg']['custom_keys']
    paths = [p for p, _ in _flat(sv['params'])]
    ids = {}
    for i, (path, value) in enumerate(_flat(sv['params'])):
        ids[path] = np.full(value.shape, i, np.float32)
    tree = {}
    for path, value in ids.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    names = {int(t.flatten()[0]): n
             for n, t in state_dict_from_jax({'params': tree}).items()}
    want = jax_paramwise_labels(sv['params'], keys)
    got = paramwise_labels(names.values(), keys)
    for i, path in enumerate(paths):
        assert got[names[i]] == want[path], (names[i], path)
    assert {v for v in got.values()} == {(1.0, 1.0), (1.0, 0.0),
                                         (10.0, 1.0)}


def test_lr_schedule_matches_jax():
    cfg = dict(policy='poly', warmup='linear', warmup_iters=1500,
               warmup_ratio=1e-6, power=1.0, min_lr=0.0)
    want = jax_lr_schedule(cfg, 6e-5, 160000)
    got = build_lr_schedule(cfg, 6e-5, 160000)
    # JAX evaluates the warmup factor in float32 (steps of 2^-23 near 1)
    for step in (0, 1, 2, 1499, 1500, 1501, 80000, 159999):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=6e-5 * 2.0 ** -23)


def test_adapters_convert_and_apply_as_jax():
    """The 1x1 channel adapters of a cross-width pair: JAX's
    ``_init_adapters`` params through ``state_dict_from_jax`` give the
    port's adapter the JAX map on NCHW and token taps."""
    entry = dict(CGD, channel_nums=(6, 9))
    adapters = jax.tree.map(np.asarray,
                            _init_adapters([entry], jax.random.key(0)))
    sd = state_dict_from_jax({'student': {'params': {
        'distill_adapters': adapters}}, 'teacher': {}})
    port = ChannelAdapter(6, 9)
    port.load_state_dict({k.split('.', 2)[2]: v for k, v in sd.items()})
    p = adapters['adapter_0']
    x = np.random.RandomState(0).randn(2, 6, 4, 5).astype(np.float32)
    want = np.einsum('bchw,cd->bdhw', x, p['kernel']) \
        + p['bias'][None, :, None, None]
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), want, 'nchw')
        tok = x.reshape(2, 6, 20).transpose(0, 2, 1).copy()
        _close(port(torch.from_numpy(tok)).numpy(), tok @ p['kernel']
               + p['bias'], 'tokens')


def test_sd_module_config_errors():
    with pytest.raises(KeyError, match='available taps'):
        m = build_segmentor(sd_cfg(distillation=[dict(
            CGD, student_layer='decode_head.nope')]))
        m.train().forward_train(torch.zeros(1, 3, 32, 32),
                                torch.zeros(1, 32, 32, dtype=torch.long), 1,
                                perm=torch.arange(NUM_CLASSES))
    # log_grad in the first entry asks the train step for the angle
    assert build_segmentor(
        sd_cfg(distillation=[dict(CGD, log_grad=True)])).log_grad
    assert not build_segmentor(sd_cfg(distillation=[dict(CGD)])).log_grad
    base = build_segmentor(sd_cfg(distillation=[])).train()
    losses = base.forward_train(torch.zeros(1, 3, 32, 32),
                                torch.zeros(1, 32, 32, dtype=torch.long), 1)
    assert set(losses) == {'decode.loss_seg', 'decode.acc_seg'}


def test_missing_checkpoints_raise(tmp_path):
    cfg = 'configs/exp_tab5/segformer_CGD.py'
    with pytest.raises(FileNotFoundError, match='t_pretrain'):
        init_segmentor_state(cfg, device='cpu',
                             cfg_options={'model.cfg_s.pretrained': None})
    with pytest.raises(FileNotFoundError, match='pretrained'):
        init_segmentor_state(cfg, device='cpu',
                             cfg_options={'model.t_pretrain': None})


# ------------------------------------------------------------- repairs

def test_fused_attention_refuses_gradients(jax_sd):
    """``fused_attention=True`` is the forward-only K2 (the JAX kernel has
    no VJP): with weights that need gradients it raises rather than cutting
    them; under no_grad, and in a frozen teacher, it still runs."""
    _, sv, _, _, _ = jax_sd
    img, gt = _port_batch(jax_sd)
    model = build_segmentor(segformer_cfg(fused_attention=True,
                                          dropout_ratio=0.0))
    model.load_state_dict(state_dict_from_jax(sv))
    with pytest.raises(NotImplementedError, match='backward'):
        model.train().forward_train(img, gt)
    with torch.no_grad():
        assert model(img).shape == (2, NUM_CLASSES, 16, 16)
    plain = _port_sd(jax_sd)
    fused = _port_sd(jax_sd, teacher_fused_attention=True)
    perm = torch.arange(NUM_CLASSES)
    want = plain.forward_train(img, gt, 1, perm=perm)
    got = fused.forward_train(img, gt, 1, perm=perm)
    for k in want:
        _close(got[k].item(), want[k].item(), k)


def test_fused_attention_train_carries_gradients(jax_sd):
    """``fused_attention='train'`` (K2 with its backward K9; their plain
    versions here) gives the unfused model's losses and gradients on the
    same weights, per stage as well as for all four."""
    _, sv, _, _, _ = jax_sd
    img, gt = _port_batch(jax_sd)
    grads = {}
    for fa in (False, 'train', [False, 'train', 'train', False]):
        model = build_segmentor(segformer_cfg(fused_attention=fa,
                                              dropout_ratio=0.0))
        model.load_state_dict(state_dict_from_jax(sv))
        total, _ = parse_losses(model.train().forward_train(img, gt)[0])
        total.backward()
        grads[str(fa)] = (total.item(), {n: p.grad for n, p in
                                         model.named_parameters()})
    want_loss, want = grads['False']
    scale = max(float(g.abs().max()) for g in want.values())
    for fa in ('train', "[False, 'train', 'train', False]"):
        loss, got = grads[fa]
        assert loss == pytest.approx(want_loss, rel=1e-6), fa
        for name, g in want.items():
            assert got[name] is not None, (fa, name)
            np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                       rtol=RTOL, atol=ATOL * scale,
                                       err_msg=f'{fa} {name}')


def test_bf16_compute_keeps_fp32_parameters(jax_sd):
    """``dtype='bfloat16'`` is the compute type: the parameters stay
    float32, and the bf16 forward stays within 5e-2 relative L2 of the JAX
    bf16 forward on the same weights."""
    model = init_segmentor(CONFIG, device='cpu',
                           cfg_options={'model.backbone.dtype': 'bfloat16'})
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    _, sv, _, img, _ = jax_sd
    jax_model = build_jax_segmentor(segformer_cfg(dtype='bfloat16'))
    want = np.asarray(jax_model.net.apply(
        sv, jnp.asarray(img), train=False, with_aux=False)['decode'],
        np.float32)
    port = build_segmentor(segformer_cfg(dtype='bfloat16'))
    port.load_state_dict(state_dict_from_jax(sv))
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    with torch.no_grad():
        got = port.eval()(_port_batch(jax_sd)[0])
    assert got.dtype == torch.bfloat16
    want = nhwc_to_nchw(want)
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 5e-2, rel


def test_dropout_draws_from_the_given_generator(jax_sd):
    """DropPath and the head's Dropout2d draw from the train step's
    generator: the same seed gives the same output, the global RNG is not
    touched, and training without a generator raises."""
    _, sv, _, _, _ = jax_sd
    model = build_segmentor(segformer_cfg(dropout_ratio=0.3,
                                          drop_path_rate=0.3))
    model.load_state_dict(state_dict_from_jax(sv))
    model.train()
    img, _ = _port_batch(jax_sd)
    rng_state = torch.get_rng_state()
    with torch.no_grad():
        a = model(img, torch.Generator().manual_seed(7))
        b = model(img, torch.Generator().manual_seed(7))
        c = model(img, torch.Generator().manual_seed(8))
    assert torch.equal(torch.get_rng_state(), rng_state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match='Generator'):
        model(img)
    x = torch.ones(4, 3, 2, 2)
    for layer in (DropPath(0.5), Dropout(0.5), Dropout(0.5, channels=True)):
        with pytest.raises(ValueError, match='Generator'):
            layer(x)
        assert torch.equal(layer.eval()(x), x)


def test_resize_sum_gradient_matches_jax_head(jax_sd):
    """K1 is an autograd Function: the SegFormer head's parameter and input
    gradients (fp32, eval BN) against the JAX head under ``jax.grad``."""
    from segdistill_tpu.models.decode_heads.segformer_head import (
        SegFormerHead as JaxSegFormerHead)
    _, sv, _, _, _ = jax_sd
    head_cfg = dict(segformer_cfg(dropout_ratio=0.0)['decode_head'])
    head_cfg.pop('type')
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, 16 // 2 ** s, 16 // 2 ** s, c).astype(np.float32)
             for s, c in enumerate((32, 64, 160, 256))]
    # the cotangent of a mean over the logits, as a loss gives
    w = (rng.randn(2, 16, 16, NUM_CLASSES) / (2 * 16 * 16 * NUM_CLASSES)) \
        .astype(np.float32)
    jhead = JaxSegFormerHead(**head_cfg)
    jvars = {'params': sv['params']['decode_head'],
             'batch_stats': sv['batch_stats']['decode_head']}

    def f(params, xs):
        out = jhead.apply({**jvars, 'params': params}, xs, train=False)
        return jnp.sum(out * w)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jvars['params'], [jnp.asarray(x) for x in feats])
    model = build_segmentor(segformer_cfg(dropout_ratio=0.0))
    model.load_state_dict(state_dict_from_jax(sv))
    head = model.decode_head.eval()
    xs = [torch.from_numpy(nhwc_to_nchw(x).copy()).requires_grad_()
          for x in feats]
    (head(xs) * torch.from_numpy(nhwc_to_nchw(w).copy())).sum().backward()
    want = state_dict_from_jax({'params': jax.tree.map(np.asarray, gp)})
    for name, p in head.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for s, (x, g) in enumerate(zip(xs, gx)):
        np.testing.assert_allclose(x.grad.numpy(), nhwc_to_nchw(g),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f'stage {s + 1}')
