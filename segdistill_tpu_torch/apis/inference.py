"""Inference API (counterpart of ``segdistill_tpu/apis/inference.py``;
reference ``mmseg/apis/inference.py:11-119``)."""

import math

import torch
import torch.nn.functional as F

from ..config import Config

from ..datasets.pipelines import Compose
from ..models import build_segmentor
from ..utils import get_root_logger
from ..utils import image as imutil
from .test import _as_lists, _predict_one


def resize_bias_table(table, rows):
    """A Swin ``relative_position_bias_table`` (S1^2, heads) -> (rows,
    heads): each head's S1 x S1 grid resized bicubically to S2 x S2 (the
    reference loader's cv2 ``INTER_CUBIC``, the same a = -0.75 kernel and
    edges; float32 on the CPU)."""
    s1, s2 = math.isqrt(table.shape[0]), math.isqrt(rows)
    grid = table.detach().cpu().float().t().reshape(1, -1, s1, s1)
    out = F.interpolate(grid, size=(s2, s2), mode='bicubic',
                        align_corners=False)
    return out.reshape(-1, rows).t().contiguous().to(table.dtype)


def _fit_swin(state, own):
    """Bring a file's Swin tensors to the model's shapes where only the
    layout or the window differs: a bias table of another window size is
    resized (:func:`resize_bias_table`) and its index buffer is the
    model's own (it follows from the window), and an
    ``absolute_pos_embed`` stored as the reference model holds it, (1, C,
    H, W), becomes the (1, H * W, C) this port holds."""
    out = dict(state)
    for k, v in state.items():
        want = own.get(k)
        if want is None or tuple(v.shape) == tuple(want.shape):
            continue
        if k.endswith('relative_position_bias_table') and v.ndim == 2 \
                and v.shape[1] == want.shape[1]:
            out[k] = resize_bias_table(v, want.shape[0])
        elif k.endswith('relative_position_index'):
            out[k] = want
        elif k.endswith('absolute_pos_embed') and v.ndim == 4 \
                and want.ndim == 3 and v.shape[1] == want.shape[2] \
                and v.shape[2] * v.shape[3] == want.shape[1]:
            out[k] = v.flatten(2).transpose(1, 2).contiguous()
    return out


def _reference_state(model, path):
    """The file's state dict (a state dict, or a dict holding one under
    'state_dict') without DDP's ``module.`` prefixes, and without the
    reference BaseDecodeHead's ``conv_seg`` classifier where the model has
    none."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    state = ckpt.get('state_dict', ckpt)
    state = {k[len('module.'):] if k.startswith('module.') else k: v
             for k, v in state.items()}
    own = model.state_dict()
    return {k: v for k, v in state.items()
            if k in own or not k.startswith('decode_head.conv_seg.')}


def match_checkpoint(model, path):
    """-> (matched, missing, unexpected) of a reference-layout ``.pth`` for
    ``model``, as :func:`load_checkpoint` takes it with ``strict=False``:
    ``matched`` the tensors the model takes (Swin's fitted,
    :func:`_fit_swin`), by name; ``missing`` the model's keys the file does
    not fill; ``unexpected`` the file's keys the model does not take."""
    own = model.state_dict()
    state = _fit_swin(_reference_state(model, path), own)
    matched = {k: v for k, v in state.items()
               if k in own and tuple(v.shape) == tuple(own[k].shape)}
    return (matched, [k for k in own if k not in matched],
            [k for k in state if k not in matched])


def load_checkpoint(model, path, strict=True):
    """Load a reference-layout ``.pth`` (a state dict, or a dict holding
    one under 'state_dict'), strictly by default. With ``strict=False``,
    as the JAX package's loader is lenient, Swin's tensors are first
    fitted to the model (:func:`_fit_swin`: a bias table of another window
    size resized), then a key the model lacks or whose shape differs is
    skipped and a key the file lacks keeps its value; the counts are
    logged (:func:`match_checkpoint`).

    The reference BaseDecodeHead always builds a ``conv_seg`` classifier,
    which SegFormerHead never runs; published SegFormer checkpoints carry
    it and this port does not, so those keys are dropped first.
    """
    if strict:
        model.load_state_dict(_reference_state(model, path), strict=True)
        return model
    matched, missing, unexpected = match_checkpoint(model, path)
    get_root_logger().info(
        f'loaded {path}: {len(matched)} tensors matched, {len(missing)} '
        f'missing, {len(unexpected)} unexpected')
    model.load_state_dict(matched, strict=False)
    return model


def load_backbone_checkpoint(model, path):
    """Load a backbone-only ``.pth`` (the config's ``pretrained``: an
    ImageNet MiT file, say) into the segmentor ``model``, leniently. Keys
    come with or without the ``backbone.`` prefix: where no key has it,
    every key gets it. Swin's tensors are fitted to the model first
    (:func:`_fit_swin`). A key the model lacks, or whose shape differs, is
    skipped; what was skipped and what the file did not fill are logged,
    nothing raises. -> (matched, missing, unexpected) key lists."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    state = ckpt
    if 'state_dict' in ckpt:
        state = ckpt['state_dict']
    elif isinstance(ckpt.get('model'), dict):
        state = ckpt['model']
    if not any(k.startswith('backbone.') for k in state):
        state = {'backbone.' + k: v for k, v in state.items()}
    own = model.state_dict()
    state = _fit_swin(state, own)
    take = {k: v for k, v in state.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(take, strict=False)
    skip = ('num_batches_tracked',)
    unexpected = [k for k in state if k not in take and not k.endswith(skip)]
    missing = [k for k in own if k not in take and not k.endswith(skip)]
    logger = get_root_logger()
    logger.info(f'loaded {path}: {len(take)} tensors matched, '
                f'{len(missing)} missing, {len(unexpected)} unexpected')
    if unexpected:
        logger.info(f'  unexpected (first 10): {unexpected[:10]}')
    if missing:
        logger.info(f'  missing (first 10): {missing[:10]}')
    return sorted(take), missing, unexpected


def student_config(cfg):
    """``cfg`` with the student's config as its model where the model is a
    distillation module (SDModule, SDModuleMT): serving and evaluation
    are the student's, and a training checkpoint holds the student
    alone."""
    if cfg.model.get('type') not in ('SDModule', 'SDModuleMT'):
        return cfg
    cfg = cfg.copy()
    student = dict(cfg.model['cfg_s'])
    student.setdefault('test_cfg', cfg.model.get('test_cfg'))
    cfg.model = student
    return cfg


def init_segmentor(config, checkpoint=None, device='cuda', seed=0,
                   cfg_options=None):
    """Build a segmentor from a config (path or :class:`Config`) with
    ``cfg_options`` (dotted keys, as ``--cfg-options`` takes them) merged
    into a copy, initialise it from ``torch.Generator().manual_seed(seed)``,
    load ``checkpoint`` if given, leniently (:func:`load_checkpoint` with
    ``strict=False``), and move it to ``device`` in eval mode (ref
    inference.py:11-39). For a distillation config (SDModule) the model is
    the student (:func:`student_config`), which the checkpoint fills, as
    the JAX ``init_segmentor`` loads into the student; ``model.cfg`` is
    then the config with the student as its model."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options:
        config = config.copy()
        config.merge_from_dict(cfg_options)
    config = student_config(config)
    model = build_segmentor(dict(config.model))
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        load_checkpoint(model, checkpoint, strict=False)
    model.cfg = config
    return model.to(device).eval()


class LoadImage:
    """Accept an in-memory HWC array or a path (ref inference.py:42-66)."""

    def __call__(self, results):
        if isinstance(results['img'], str):
            results['filename'] = results['img']
            results['ori_filename'] = results['img']
            results['img'] = imutil.imread(results['img'])
        else:
            results['filename'] = None
            results['ori_filename'] = None
        img = results['img']
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


def serving_pipeline(cfg):
    """The config's test pipeline with its file loader swapped for
    :class:`LoadImage`."""
    return Compose([LoadImage()] + list(cfg.data['test']['pipeline'][1:]))


def inference_segmentor(model, img):
    """-> [label map] for one image, an HWC BGR uint8 array or a path
    (ref inference.py:69-98)."""
    data = serving_pipeline(model.cfg)(dict(img=img))
    return [_predict_one(model, *_as_lists(data))]


def show_result_pyplot(model, img, result, palette=None, fig_size=(15, 10),
                       opacity=0.5, out_file=None):
    """Paint ``result[0]`` over ``img`` (an array or a path) with
    ``model.show_result``, and write it to ``out_file`` where given (PNG
    with the port's encoder); -> the painted BGR image. No window is
    drawn: ``fig_size`` is accepted for the reference's signature (ref
    inference.py:101-119)."""
    if isinstance(img, str):
        img = imutil.imread(img)
    drawn = model.show_result(img, result[0], palette=palette,
                              opacity=opacity)
    if out_file is not None:
        imutil.imwrite(drawn, out_file)
    return drawn
