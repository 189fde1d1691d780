"""Inference API (counterpart of ``segdistill_tpu/apis/inference.py``;
reference ``mmseg/apis/inference.py:11-119``)."""

import torch

from segdistill_tpu.config import Config

from ..datasets.pipelines import Compose
from ..models import build_segmentor
from ..utils import image as imutil
from .test import _as_lists, _predict_one


def load_checkpoint(model, path, strict=True):
    """Load a reference-layout ``.pth`` (a state dict, or a dict holding
    one under 'state_dict'), strictly by default.

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
    model.load_state_dict(state, strict=strict)
    return model


def init_segmentor(config, checkpoint=None, device='cuda', seed=0,
                   cfg_options=None):
    """Build a segmentor from a config (path or :class:`Config`) with
    ``cfg_options`` (dotted keys, as ``--cfg-options`` takes them) merged
    into a copy, initialise it from ``torch.Generator().manual_seed(seed)``,
    load ``checkpoint`` if given, and move it to ``device`` in eval mode
    (ref inference.py:11-39)."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options:
        config = config.copy()
        config.merge_from_dict(cfg_options)
    model_cfg = dict(config.model)
    model_cfg.pop('pretrained', None)
    model = build_segmentor(model_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        load_checkpoint(model, checkpoint)
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
