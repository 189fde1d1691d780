"""The port's tool twins on the CPU, each through its ``main(argv)``: the
parameter and FLOP count (``get_flops``), the checkpoint converter
(``convert_checkpoint``), the one-image demo (``image_demo``), the release
stamp (``publish_model``) and the inference benchmark (``benchmark``), on
a narrow MiT-b0 + SegFormerHead (head embed 32, 4 classes) at 64x64.

Against the JAX package: the parameter count of its ``tools/get_flops.py``
(the same expression on the same config's variables); the converter's
output loaded into the port and the same ``.pth`` read by the JAX
``load_pth_into_variables`` give logits within 1e-5 of the largest |logit|
(both fp32 on the CPU), whole and backbone-only.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.convert import load_pth_into_variables
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                       load_checkpoint)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.tools import (benchmark, convert_checkpoint,
                                        get_flops, image_demo, publish_model)
from segdistill_tpu_torch.utils import image as imutil

from torch_port_fixtures import (narrow_segformer_cfg, pipeline_cfg,
                                 random_jax_variables)

HW = (64, 64)
LOGIT_TOL = 1e-5  # of the largest |logit|
CLASSES, EMBED = 4, 32
MIT_B0 = dict(dims=(32, 64, 160, 256), depths=(2, 2, 2, 2),
              sr=(8, 4, 2, 1), mlp=4)


@pytest.fixture(scope='module')
def config(tmp_path_factory):
    """A config file of the narrow model with a 64x64 test pipeline."""
    path = tmp_path_factory.mktemp('tools') / 'narrow.py'
    path.write_text(f'model = {narrow_segformer_cfg()!r}\n'
                    f'data = dict(test=dict(pipeline='
                    f'{pipeline_cfg(img_scale=HW)!r}))\n')
    return str(path)


def _hand_flops():
    """The products of the narrow model's ``encode_decode`` at 64x64,
    counted by hand, 2 a multiply-add: the patch embeddings, each block's
    q, spatial reduction, kv, attention, projection and MLP (its 3x3
    depthwise convolution included), then the head, which folds each
    scale's linear into the fuse convolution (the weight products and the
    bias vector) before one product a scale, and the classifier."""
    total, cin, side, scales = 0, 3, HW[0], []
    for s, C in enumerate(MIT_B0['dims']):
        k, stride, pad = (7, 4, 3) if s == 0 else (3, 2, 1)
        side = (side + 2 * pad - k) // stride + 1
        N = side * side
        total += 2 * N * C * cin * k * k
        sr = MIT_B0['sr'][s]
        M = (side // sr) ** 2
        hidden = MIT_B0['mlp'] * C
        block = 2 * N * C * C                      # q
        block += 2 * M * C * C * sr * sr if sr > 1 else 0
        block += 2 * M * C * 2 * C                 # kv
        block += 4 * N * M * C                     # q k^T and P v
        block += 2 * N * C * C                     # proj
        block += 2 * N * C * hidden * 2 + 2 * N * hidden * 9
        total += MIT_B0['depths'][s] * block
        scales.append((N, C))
        cin = C
    for N, C in scales:
        total += 2 * C * EMBED * EMBED + 2 * EMBED * EMBED
        total += 2 * N * C * EMBED
    return total + 2 * scales[0][0] * EMBED * CLASSES


def test_get_flops(config, capsys):
    params, flops, by_op = get_flops.main([config, '--shape', str(HW[0]),
                                           '--device', 'cpu'])
    out = capsys.readouterr().out
    assert f'Params: {params / 1e6:.2f} M ({params})' in out
    assert 'Multiply-adds' in out and 'Input shape: (1, 3, 64, 64)' in out
    # the JAX tool's count: every leaf of the config's 'params'
    jax_model = build_jax_segmentor(narrow_segformer_cfg())
    variables = random_jax_variables(jax_model)
    assert params == sum(int(np.prod(p.shape))
                         for p in jax.tree.leaves(variables['params']))
    assert flops == _hand_flops()
    assert set(by_op) <= {'aten.convolution', 'aten.addmm', 'aten.mm',
                          'aten.bmm'}
    fused = init_segmentor(config, device='cpu', cfg_options={
        'model.backbone.fused_attention': True})
    _, fused_flops, fused_by_op = get_flops.count(fused, (1, 3, *HW))
    assert fused_flops == flops
    assert fused_by_op['segdistill.sra_attention'] == by_op['aten.bmm']


def _reference_file(state, path, prefix='module.'):
    """``state`` as a reference checkpoint: DDP prefixes, a 'state_dict'
    wrapper and the reference head's unused classifier."""
    sd = {prefix + k: v for k, v in state.items()}
    sd[prefix + 'decode_head.conv_seg.weight'] = torch.zeros(CLASSES, 32, 1,
                                                             1)
    torch.save({'state_dict': sd, 'meta': {}}, path)


def _logits(port, jax_model, variables, img):
    with torch.no_grad():
        got = port.encode_decode(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_model.encode_decode(
        variables, jnp.asarray(img.transpose(0, 2, 3, 1))))
    return got, want.transpose(0, 3, 1, 2)


def test_convert_checkpoint_against_jax_loader(config, tmp_path):
    source = build_segmentor(narrow_segformer_cfg())
    source.init_weights(torch.Generator().manual_seed(3))
    full = tmp_path / 'full.pth'
    _reference_file(source.state_dict(), full)
    out = tmp_path / 'converted.pth'
    matched, missing, unexpected = convert_checkpoint.main(
        [config, str(full), str(out)])
    assert not missing and unexpected == []
    assert sorted(torch.load(out)['state_dict']) == matched
    port = build_segmentor(narrow_segformer_cfg())
    port.load_state_dict(torch.load(out)['state_dict'], strict=True)
    port.eval()
    jax_model = build_jax_segmentor(narrow_segformer_cfg())
    variables = load_pth_into_variables(random_jax_variables(jax_model, 5),
                                        str(full), jax_model)
    img = np.random.RandomState(1).randn(1, 3, *HW).astype(np.float32)
    got, want = _logits(port, jax_model, variables, img)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()

    # a backbone file (no 'backbone.' prefix) of other weights, over both
    other = build_segmentor(narrow_segformer_cfg())
    other.init_weights(torch.Generator().manual_seed(6))
    backbone = tmp_path / 'backbone.pth'
    torch.save({k[len('backbone.'):]: v for k, v in
                other.state_dict().items() if k.startswith('backbone.')},
               backbone)
    out_b = tmp_path / 'converted_backbone.pth'
    matched, missing, _ = convert_checkpoint.main(
        [config, str(backbone), str(out_b), '--backbone-only'])
    assert matched and all(k.startswith('backbone.') for k in matched)
    assert missing and not any(k.startswith('backbone.') for k in missing)
    load_checkpoint(port, str(out_b), strict=False)
    variables = load_pth_into_variables(variables, str(backbone), jax_model,
                                        backbone_only=True)
    got, want = _logits(port, jax_model, variables, img)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    for k, v in other.state_dict().items():
        if k.startswith('backbone.') and v.is_floating_point():
            assert torch.equal(port.state_dict()[k], v), k


def test_image_demo_writes_the_painted_labels(config, tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (48, 80, 3)) \
        .astype(np.uint8)
    path = tmp_path / 'img.png'
    imutil.imwrite(img, str(path))
    out = tmp_path / 'painted.png'
    labels = image_demo.main([str(path), config, '--out-file', str(out),
                              '--device', 'cpu'])
    model = init_segmentor(config, device='cpu')
    want = inference_segmentor(model, img)[0]
    np.testing.assert_array_equal(labels, want)
    np.testing.assert_array_equal(imutil.imread(str(out)),
                                  model.show_result(img, want, opacity=0.5))


@pytest.mark.parametrize('kind', ['file', 'dir'])
def test_publish_model_names_by_sha256(tmp_path, kind):
    data = np.random.RandomState(4).bytes(3000)
    if kind == 'file':
        src = tmp_path / 'latest.pth'
        src.write_bytes(data)
        digest = hashlib.sha256(data).hexdigest()[:8]
    else:
        src = tmp_path / 'ckpt'
        src.mkdir()
        (src / 'b.bin').write_bytes(data[1000:])
        (src / 'a.bin').write_bytes(data[:1000])
        digest = hashlib.sha256(data).hexdigest()[:8]  # a.bin, then b.bin
    final = publish_model.main([str(src), str(tmp_path / 'm.pth')])
    assert final == str(tmp_path / f'm-{digest}.pth')
    if kind == 'file':
        assert open(final, 'rb').read() == data


def test_benchmark_prints_its_lines(config, capsys):
    fps = benchmark.main([config, '--device', 'cpu', '--iters', '2',
                          '--warmup', '1', '--log-interval', '1',
                          '--shape', *map(str, HW)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('Done image [  1/2], fps: ')
    assert lines[1].startswith('Done image [  2/2], fps: ')
    assert lines[2] == f'Overall fps: {fps:.2f} img/s' and fps > 0
