"""Inference API (counterpart of ``segdistill_tpu/apis/inference.py``;
reference ``mmseg/apis/inference.py:11-119``)."""

import torch

from ..config import Config

from ..datasets.pipelines import Compose
from ..models import build_segmentor
from ..utils import get_root_logger
from ..utils import image as imutil
from .test import _as_lists, _predict_one


def load_checkpoint(model, path, strict=True):
    """Load a reference-layout ``.pth`` (a state dict, or a dict holding
    one under 'state_dict'), strictly by default. With ``strict=False``,
    as the JAX package's loader is lenient, a key the model lacks or whose
    shape differs is skipped and a key the file lacks keeps its value;
    the counts are logged.

    The reference BaseDecodeHead always builds a ``conv_seg`` classifier,
    which SegFormerHead never runs; published SegFormer checkpoints carry
    it and this port does not, so those keys are dropped first.
    """
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    state = ckpt.get('state_dict', ckpt)
    state = {k[len('module.'):] if k.startswith('module.') else k: v
             for k, v in state.items()}
    own = model.state_dict()
    state = {k: v for k, v in state.items()
             if k in own or not k.startswith('decode_head.conv_seg.')}
    if not strict:
        take = {k: v for k, v in state.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        get_root_logger().info(
            f'loaded {path}: {len(take)} tensors matched, '
            f'{len(own) - len(take)} missing, '
            f'{len(state) - len(take)} unexpected')
        state = take
    model.load_state_dict(state, strict=strict)
    return model


def load_backbone_checkpoint(model, path):
    """Load a backbone-only ``.pth`` (the config's ``pretrained``: an
    ImageNet MiT file, say) into the segmentor ``model``, leniently. Keys
    come with or without the ``backbone.`` prefix: where no key has it,
    every key gets it. A key the model lacks, or whose shape differs, is
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
    model_cfg = dict(config.model)
    model_cfg.pop('pretrained', None)
    model = build_segmentor(model_cfg)
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
