"""K10's launch plan (``ops/ln_plan.py``) and its walk over the rows,
modelled on the CPU.

K10 (``csrc/layer_norm.cu``, ``ln_fwd``) gives a row to a group of
``lanes`` lanes, lane l holding vectors l, l + lanes, ... (``nch`` of
them); a block of ``threads`` holds ``threads / lanes`` groups. A group
owns one row (``rows_in_flight`` 1), or walks rows grid-stride with the
next row's loads issued before the current row is finished (2). Here:

- every plan, at every shape of the train step and the serving path, at
  ``kernel_cases.LN_CASES`` and at every width 8..1024 in both dtypes,
  covers every (row, vector) once, within the source's register budget and
  grid limits, with no idle lane at C = 160 and 320;
- a numpy model of the walk, with the kernel's order of sums (a lane's
  values in order, then an xor tree over the group) in float64 and in
  float32, equals ``layer_norm_plain`` within 2e-5 on N(0, 1) rows, and the
  JAX kernel in interpret mode where its gates take the shape;
- the step's (rows, C, launches), derived from the B0 and B3 backbones of
  ``configs/exp_tab5/segformer_CGD.py``, are the case lists' and total
  30 + 89;
- the constants and instances mirror the source, and the wrapper launches
  the plan.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_ln
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.models.builder import build_backbone
from segdistill_tpu_torch.ops import layer_norm as ln
from segdistill_tpu_torch.ops import ln_plan
from segdistill_tpu_torch.tools import kernel_cases

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / 'segdistill_tpu_torch' / 'csrc' / 'layer_norm.cu').read_text()
SMS = 132  # the H100's SMs
CODES = {'float32': 0, 'bfloat16': 1}
# the CGD and PD train step's batch and image edge (tools/profile_train.py)
BATCH, EDGE = 8, 512

SHAPES = sorted({(rows, c) for _, rows, c in kernel_cases.LN_CASES})


def walk(plan, rows, C, code):
    """The rows each group finishes, in the kernel's loop, as an int array
    (-1 where none): -> (finished (turns, blocks, groups), vectors a lane
    holds (lanes, nch), -1 past the row's end). At two rows in flight the
    model also follows its two buffers: a row is finished from the buffer
    its loads went to."""
    groups = plan.threads // plan.lanes
    step = plan.blocks * groups
    base = np.arange(plan.blocks, dtype=np.int64) * groups  # per block
    group = np.arange(groups)[None, :]
    done = []
    live = base < rows
    if plan.rows_in_flight == 1:              # one row a group, no loop
        r = base[:, None] + group
        done.append(np.where(live[:, None] & (r < rows), r, -1))
    else:
        a = base[:, None] + group            # the row in buffer a
        while live.any():
            r = base[:, None] + group
            n = r + step                     # the next row's loads first
            done.append(np.where(live[:, None],
                                 np.where(a != r, -2,
                                          np.where(r < rows, r, -1)), -1))
            more = live & (base + step < rows)
            a = np.where(more[:, None], r + 2 * step, a)
            done.append(np.where(more[:, None] & (n < rows), n, -1))
            base = base + 2 * step
            live = more & (base < rows)
    nvec = C // ln_plan.VEC[code]
    vec = np.arange(plan.lanes)[:, None] + plan.lanes * np.arange(plan.nch)
    return np.array(done), np.where(vec < nvec, vec, -1)


def check_plan(rows, C, code, sms=SMS):
    plan = ln_plan.forward_plan(rows, C, code, sms)
    V = ln_plan.VEC[code]
    nvec = C // V
    assert tuple(plan[:3]) in ln_plan.INSTANCES[code]
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes * plan.nch * V >= C
    assert plan.nch * V <= ln_plan.MAX_VALUES
    assert plan.threads in (32, 64, 128, 256) \
        and plan.threads % plan.lanes == 0
    groups = plan.threads // plan.lanes
    assert 1 <= plan.blocks <= -(-rows // groups) and plan.blocks < 2 ** 31
    if plan.rows_in_flight == 2:
        assert plan.blocks <= sms * ln_plan.PERSISTENT_BLOCKS_PER_SM
    finished, vec = walk(plan, rows, C, code)
    assert not (finished == -2).any(), 'a row finished from the wrong buffer'
    got = finished[finished >= 0]
    assert np.bincount(got, minlength=rows).tolist() == [1] * rows
    held = vec[vec >= 0]
    assert np.bincount(held, minlength=nvec).tolist() == [1] * nvec
    if C in (160, 320):
        assert plan.lanes * plan.nch == nvec, 'an idle lane'
    return plan


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rows,C', SHAPES)
def test_plan_covers_each_case_once(rows, C, dtype):
    check_plan(rows, C, CODES[dtype])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rows', [1, 7, 2048, 131072])
def test_plan_covers_every_width(rows, dtype):
    for C in range(8, 1025, 8):
        check_plan(rows, C, CODES[dtype])


@pytest.mark.parametrize('name,rows,C,launches,want',
                         kernel_cases.LN_STEP_CASES
                         + kernel_cases.LN_SERVING_CASES)
def test_case_plans_are_the_planners(name, rows, C, launches, want):
    """The plan each case names (``chip_smoke.py`` asserts it on the
    card): the step's in bf16, the serving path's in fp32. At 2048 rows the
    grid covers the card's SMs, where a block of 64 threads can."""
    code = 1 if (name, rows, C, launches, want) in \
        kernel_cases.LN_STEP_CASES else 0
    plan = check_plan(rows, C, code)
    assert tuple(plan[:4]) == want
    if rows == 2048 and rows * plan.lanes >= SMS * 64:
        assert plan.blocks >= SMS


def test_rows_in_flight_only_where_one_row_a_group_overflows_the_card():
    for rows, C, code in ((131072, 32, 1), (131072, 64, 1),
                          (32768, 128, 1), (2 ** 20, 32, 0)):
        plan = ln_plan.forward_plan(rows, C, code, SMS)
        assert plan.rows_in_flight == 2 and plan.threads == 256
        assert plan.blocks == SMS * ln_plan.PERSISTENT_BLOCKS_PER_SM
    # one wave holds every row: one row a group
    assert ln_plan.forward_plan(32768, 64, 1, SMS).rows_in_flight == 1
    # wide rows keep one row a group at any count (no two-row instance)
    assert ln_plan.forward_plan(131072, 512, 1, SMS).rows_in_flight == 1


def lanes_sum(v, axis_lanes):
    """The kernel's group sum: an xor tree, offsets lanes / 2 down to 1,
    ``v[..., lane]`` + ``v[..., lane ^ off]`` (every lane gets the sum)."""
    lanes = v.shape[axis_lanes]
    off = lanes // 2
    while off:
        v = v + np.take(v, np.arange(lanes) ^ off, axis=axis_lanes)
        off //= 2
    return v


def model_forward(x, w, b, eps, plan, code, dt):
    """K10 in numpy type ``dt`` over (rows, C) ``x``, row by row as the walk
    finishes them: a lane's values summed in (vector, element) order, the
    group's sums by the xor tree, the mean, the centred square, rstd, y.
    Rows the walk never finishes stay NaN."""
    rows, C = x.shape
    V = ln_plan.VEC[code]
    nvec = C // V
    G, nch = plan.lanes, plan.nch
    vec = np.arange(G)[:, None] + G * np.arange(nch)   # (G, nch)
    real = vec < nvec
    xv = np.zeros((rows, G, nch, V), dt)
    xv[:, real] = x.astype(dt).reshape(rows, nvec, V)[:, vec[real]]
    s = np.zeros((rows, G), dt)
    for i in range(nch):
        for j in range(V):
            s = s + xv[:, :, i, j]
    inv_c = dt(1) / dt(C)
    mu = lanes_sum(s, 1)[:, :1, None, None] * inv_c
    xc = np.where(real[None, :, :, None], xv - mu, xv)
    sq = np.zeros((rows, G), dt)
    for i in range(nch):
        for j in range(V):
            sq = sq + np.where(real[None, :, i], xc[:, :, i, j] ** 2, dt(0))
    rstd = dt(1) / np.sqrt(lanes_sum(sq, 1)[:, :1, None, None] * inv_c
                           + dt(eps))
    wv = np.zeros((G, nch, V), dt)
    bv = np.zeros((G, nch, V), dt)
    wv[real] = w.astype(dt).reshape(nvec, V)[vec[real]]
    bv[real] = b.astype(dt).reshape(nvec, V)[vec[real]]
    yv = xc * rstd * wv + bv
    y = np.full((rows, C), np.nan)
    finished, _ = walk(plan, rows, C, code)
    order = finished[finished >= 0]
    flat = np.zeros((rows, nvec, V), dt)
    flat[:, vec[real]] = yv[:, real]
    y[order] = flat.reshape(rows, C)[order]
    return y


@pytest.mark.parametrize('dt', [np.float64, np.float32])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rows,C', [(1001, 160), (2048, 320), (300, 256),
                                    (77, 1000), (40, 1024), (9, 8),
                                    (131, 24), (2001, 32), (1500, 64),
                                    (1100, 128)])
def test_walk_model_equals_the_plain_version(rows, C, dtype, dt):
    """On N(0, 1) rows (rounded to bf16 for the bf16 plan), under the H100's
    plan and that of a card of 2 SMs, where rows outnumber the card's
    threads sooner: two rows in flight where a row is at most 32 vectors,
    also on a grid smaller than the rows need (a group walks several
    rows)."""
    code = CODES[dtype]
    rng = np.random.RandomState(rows + C)
    x = torch.from_numpy(rng.randn(rows, C).astype(np.float32))
    if dtype == 'bfloat16':
        x = x.bfloat16().float()
    w = torch.from_numpy((1 + 0.1 * rng.randn(C)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(C)).astype(np.float32))
    want = ln.layer_norm_plain(x, w, b, 1e-6).numpy()
    plans = set()
    for sms in (SMS, 2):
        full = ln_plan.forward_plan(rows, C, code, sms)
        plans.add(full)
        if full.rows_in_flight == 2:
            plans.add(full._replace(blocks=max(1, full.blocks // 3)))
    for plan in plans:
        got = model_forward(x.numpy(), w.numpy(), b.numpy(), 1e-6, plan,
                            code, dt)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize('shape', [(512, 32), (512, 64)])
def test_walk_model_equals_the_jax_kernel(shape):
    """The float32 model against the TPU kernel in interpret mode, at
    widths its gates take."""
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[1])).astype(np.float32)
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1e-6, interpret=True))
    for code in (0, 1):
        plan = ln_plan.forward_plan(shape[0], shape[1], code, SMS)
        got = model_forward(x, w, b, 1e-6, plan, code, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _backbone_norms(backbone_cfg, batch, edge):
    """{(rows, C): launches} of every LayerNorm of the backbone on a batch
    of ``edge`` x ``edge`` images: stage s's tokens at stride 4 * 2^(s-1),
    the SRA norm's at ``sr_ratio`` times that."""
    with torch.device('meta'):
        net = build_backbone(dict(backbone_cfg))
    out = {}
    for name, m in net.named_modules():
        if not isinstance(m, torch.nn.LayerNorm):
            continue
        s = int(re.search(r'(\d)', name).group(1))
        side = edge // (4 * 2 ** (s - 1))
        if name.endswith('attn.norm'):
            blk = net.get_submodule(name.rsplit('.', 2)[0])
            side //= blk.attn.sr_ratio
        key = (batch * side * side, m.normalized_shape[0])
        out[key] = out.get(key, 0) + 1
    return out


def test_step_launches_follow_from_the_configs():
    cfg = Config.fromfile(str(ROOT / 'configs' / 'exp_tab5'
                              / 'segformer_CGD.py'))
    student = _backbone_norms(cfg.model.cfg_s.backbone, BATCH, EDGE)
    teacher = _backbone_norms(cfg.model.cfg_t.backbone, BATCH, EDGE)
    assert sum(student.values()) == 30 and sum(teacher.values()) == 89
    # (2048, 64) is both B0's stage-2 and B3's stage-1 SRA norm
    cases = {}
    for name, rows, c, n, _ in kernel_cases.LN_STEP_CASES:
        want = (student if name.startswith('B0') else teacher)[(rows, c)]
        assert n == want, name
        cases[(rows, c)] = cases.get((rows, c), 0) + n
    merged = dict(student)
    for key, n in teacher.items():
        merged[key] = merged.get(key, 0) + n
    assert merged == cases
    serving = _backbone_norms(cfg.model.cfg_s.backbone, 1, EDGE)
    assert serving == {(rows, c): n for name, rows, c, n, _ in
                       kernel_cases.LN_SERVING_CASES}
    listed = {(rows, c) for _, rows, c in kernel_cases.LN_CASES}
    assert set(merged) <= listed and set(serving) <= listed


def test_constants_and_instances_mirror_the_source():
    assert int(re.search(r'kFwdMaxValues = (\d+);', SOURCE).group(1)) \
        == ln_plan.MAX_VALUES
    assert int(re.search(r'kFwdMaxThreads = (\d+);', SOURCE).group(1)) \
        == max(ln_plan.BLOCK_THREADS)
    listed = re.findall(r'X\((\d), \w+, (\d+), (\d+), (\d+)\)', SOURCE)
    got = {0: set(), 1: set()}
    for code, lanes, nch, rif in listed:
        got[int(code)].add((int(lanes), int(nch), int(rif)))
    assert sum(map(len, got.values())) == len(listed)
    for code, instances in ln_plan.INSTANCES.items():
        assert got[code] == set(instances)
        for lanes, nch, rif in instances:
            assert nch * ln_plan.VEC[code] <= ln_plan.MAX_VALUES
            assert lanes in (4, 8, 16, 32) and rif in (1, 2)
            assert rif == 1 or nch == 1


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_every_instance_is_planned_at_some_width(dtype):
    """The instance list holds nothing the rules never take."""
    code = CODES[dtype]
    taken = set()
    for C in range(8, 1025, 8):
        for rows in (1, 2048, 2 ** 20):
            taken.add(tuple(ln_plan.forward_plan(rows, C, code, SMS)[:3]))
    assert taken == set(ln_plan.INSTANCES[code])


@pytest.mark.parametrize('shape,dtype', [((4, 2048, 32), torch.bfloat16),
                                         ((8192, 320), torch.bfloat16),
                                         ((3, 7, 160), torch.float32)])
def test_wrapper_launches_the_plan(monkeypatch, shape, dtype):
    """``_launch_fwd`` hands the C entry the rows' pointer, stride and
    count, then the plan of those rows on the device's SM count, then the
    programmatic-launch switch; nothing is launched here."""
    calls = []
    monkeypatch.setattr(ln, 'device_sm_count', lambda device: SMS)
    monkeypatch.setattr(ln.FWD_KERNEL, 'launch',
                        lambda device, *args: calls.append(args))
    x = torch.zeros(shape, dtype=dtype)
    w, b = torch.ones(shape[-1]), torch.zeros(shape[-1])
    y, xrows, plan = ln._launch_fwd(x, w, b, 1e-6)
    rows = x.numel() // shape[-1]
    want = ln_plan.forward_plan(rows, shape[-1], ln.DTYPE_CODES[dtype], SMS)
    (args,) = calls
    assert args[0] == x.data_ptr() and args[1:8] == (
        shape[-1], w.data_ptr(), b.data_ptr(), rows, shape[-1], 1e-6,
        ln.DTYPE_CODES[dtype])
    assert args[8] == y.data_ptr() and args[9:14] == tuple(want)
    assert args[14] is ln.PDL
    assert plan == (shape[-1], rows, shape[-1], ln.DTYPE_CODES[dtype],
                    x.shape) and xrows is x
