"""EncoderDecoder, inference side (counterpart of
``segdistill_tpu/models/segmentors/encoder_decoder.py``; reference
``mmseg/models/segmentors/encoder_decoder.py``).

Images and logits are NCHW. ``slide_inference`` keeps the reference's
overlap-window count-matrix averaging (ref :169-212).
"""

import torch

from ...ops import resize
from .. import builder
from ..builder import SEGMENTORS
from .base import BaseSegmentor


@SEGMENTORS.register_module()
class EncoderDecoder(BaseSegmentor):

    def __init__(self, backbone, decode_head, neck=None, auxiliary_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        del train_cfg  # training settings: used by the training port
        if neck is not None or auxiliary_head is not None:
            raise NotImplementedError(
                'necks and auxiliary heads are not ported yet; the ported '
                'slice is the SegFormer serving path')
        if pretrained is not None:
            raise NotImplementedError(
                'loading pretrained backbone weights is a training-time step '
                'and not ported yet; pass a full checkpoint to '
                'init_segmentor instead')
        self.test_cfg = test_cfg or {}
        self.backbone = builder.build_backbone(backbone)
        self.decode_head = builder.build_head(decode_head)
        self.align_corners = self.decode_head.align_corners
        self.num_classes = self.decode_head.num_classes

    @torch.no_grad()
    def init_weights(self, generator):
        """Random initialisation from one ``torch.Generator``."""
        self.backbone.init_weights(generator)
        self.decode_head.init_weights(generator)

    def extract_feat(self, img):
        return self.backbone(img)

    def forward(self, img):
        """Head logits at the head's resolution, (B, classes, h, w)."""
        return self.decode_head(self.extract_feat(img))

    def encode_decode(self, img):
        """fp32 logits resized to the input resolution (ref :84-94)."""
        return resize(self(img).float(), size=img.shape[2:], mode='bilinear',
                      align_corners=self.align_corners)

    def whole_inference(self, img, ori_shape=None, rescale=False):
        seg_logit = self.encode_decode(img)
        if rescale and ori_shape is not None \
                and tuple(ori_shape[:2]) != tuple(img.shape[2:]):
            seg_logit = resize(seg_logit, size=ori_shape[:2],
                               mode='bilinear',
                               align_corners=self.align_corners)
        return seg_logit

    def slide_inference(self, img, ori_shape=None, rescale=False):
        """Overlap-window inference with count-matrix averaging."""
        h_stride, w_stride = self.test_cfg['stride']
        h_crop, w_crop = self.test_cfg['crop_size']
        B, _, h_img, w_img = img.shape
        h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
        w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
        preds = img.new_zeros((B, self.num_classes, h_img, w_img),
                              dtype=torch.float32)
        count = img.new_zeros((1, 1, h_img, w_img), dtype=torch.float32)
        for hi in range(h_grids):
            for wi in range(w_grids):
                y1 = min(hi * h_stride, max(h_img - h_crop, 0))
                x1 = min(wi * w_stride, max(w_img - w_crop, 0))
                y2 = min(y1 + h_crop, h_img)
                x2 = min(x1 + w_crop, w_img)
                logit = self.encode_decode(img[:, :, y1:y2, x1:x2])
                preds[:, :, y1:y2, x1:x2] += logit
                count[:, :, y1:y2, x1:x2] += 1
        preds = preds / count
        if rescale and ori_shape is not None \
                and tuple(ori_shape[:2]) != (h_img, w_img):
            preds = resize(preds, size=ori_shape[:2], mode='bilinear',
                           align_corners=self.align_corners)
        return preds

    def inference_logits(self, img, ori_shape=None, rescale=False):
        """Logits by the configured test mode ('whole' or 'slide')."""
        if self.test_cfg.get('mode', 'whole') == 'slide':
            return self.slide_inference(img, ori_shape, rescale)
        return self.whole_inference(img, ori_shape, rescale)

    def inference(self, img, ori_shape=None, rescale=False, flip=False,
                  flip_direction='horizontal'):
        """Softmax probabilities with the flip undone (ref :228-261)."""
        output = self.inference_logits(img, ori_shape, rescale).softmax(dim=1)
        if flip:
            dim = 3 if flip_direction == 'horizontal' else 2
            output = output.flip(dims=(dim,))
        return output

    def simple_test(self, img, ori_shape=None, rescale=True, flip=False,
                    flip_direction='horizontal'):
        return self.inference(img, ori_shape, rescale, flip,
                              flip_direction).argmax(dim=1)

    def aug_test(self, imgs, metas, rescale=True):
        """Average softmax probabilities over augmented views
        (ref :263-293)."""
        if not rescale:
            raise ValueError('aug_test needs rescale=True')
        acc = None
        for img, meta in zip(imgs, metas):
            probs = self.inference(
                img, ori_shape=meta.get('ori_shape'), rescale=True,
                flip=meta.get('flip', False),
                flip_direction=meta.get('flip_direction', 'horizontal'))
            acc = probs if acc is None else acc + probs
        return (acc / len(imgs)).argmax(dim=1)
