"""EncoderDecoder (counterpart of
``segdistill_tpu/models/segmentors/encoder_decoder.py``; reference
``mmseg/models/segmentors/encoder_decoder.py``).

Images and logits are NCHW. ``extract_feat`` runs the backbone and, where
the config has one, the neck. ``forward_train`` returns the head's losses
under the 'decode.' prefix, an auxiliary head's under 'aux.' (a list of
them under 'aux_{i}.'; they run in training only), and the requested
feature taps; BN running statistics update in place, as torch does.
``slide_inference`` keeps the reference's overlap-window count-matrix
averaging (ref :169-212).
"""

import contextlib

import torch
from torch import nn

from ...ops import resize
from .. import builder
from ..builder import SEGMENTORS
from ..utils import capture_taps
from .base import BaseSegmentor, add_prefix


@SEGMENTORS.register_module()
class EncoderDecoder(BaseSegmentor):

    def __init__(self, backbone, decode_head, neck=None, auxiliary_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        del train_cfg  # no train-time options in the ported heads
        if pretrained is not None:
            raise NotImplementedError(
                'loading pretrained backbone weights is a training-time step '
                'and not ported yet; pass a full checkpoint to '
                'init_segmentor instead')
        self.test_cfg = test_cfg or {}
        self.backbone = builder.build_backbone(backbone)
        self.neck = builder.build_neck(neck) if neck is not None else None
        self._init_decode_head(decode_head)
        if isinstance(auxiliary_head, (list, tuple)):
            self.auxiliary_head = nn.ModuleList(
                builder.build_head(c) for c in auxiliary_head)
        elif auxiliary_head is not None:
            self.auxiliary_head = builder.build_head(auxiliary_head)
        else:
            self.auxiliary_head = None

    def _init_decode_head(self, decode_head):
        self.decode_head = builder.build_head(decode_head)
        self.align_corners = self.decode_head.align_corners
        self.num_classes = self.decode_head.num_classes

    def _aux_heads(self):
        """-> [(loss prefix, head)] of the auxiliary heads (ref :102-126)."""
        aux = self.auxiliary_head
        if aux is None:
            return []
        if isinstance(aux, nn.ModuleList):
            return [(f'aux_{i}', h) for i, h in enumerate(aux)]
        return [('aux', aux)]

    @torch.no_grad()
    def init_weights(self, generator):
        """Random initialisation from one ``torch.Generator``."""
        for part in (self.backbone, self.neck, self.decode_head,
                     self.auxiliary_head):
            for m in (part if isinstance(part, nn.ModuleList) else [part]):
                if m is not None:
                    m.init_weights(generator)

    def extract_feat(self, img, generator=None):
        x = self.backbone(img, generator)
        return x if self.neck is None else self.neck(x)

    def forward(self, img, generator=None):
        """Head logits at the head's resolution, (B, classes, h, w).
        Dropout in training mode draws from ``generator``. A head with
        several outputs (DAHead, EncHead with its se logits) gives its
        first, the primary logits, which every inference path takes (ref
        da_head.py / enc_head.py ``forward_test``); training passes the
        whole tuple to the head's losses (:meth:`_decode_train`)."""
        out = self.decode_head(self.extract_feat(img, generator), generator)
        return out[0] if isinstance(out, tuple) else out

    def _decode_train(self, x, gt_semantic_seg, generator, points):
        """The decode head's losses under 'decode.' (a cascade: each
        stage's)."""
        del points  # a cascade's point head draws them
        logits = self.decode_head(x, generator)
        return add_prefix(self.decode_head.losses(logits, gt_semantic_seg),
                          'decode')

    def forward_train(self, img, gt_semantic_seg, capture=(),
                      generator=None, points=None):
        """-> (the decode head's and the auxiliary heads' losses:
        'decode.loss_seg', 'decode.acc_seg', 'aux.loss_seg', ...; {tap
        name: tensor} for the taps named in ``capture``) (ref :136-166).
        ``points`` (a cascade with a point head) overrides the point head's
        draw of its training points."""
        with capture_taps(self, capture) if capture \
                else contextlib.nullcontext({}) as feats:
            x = self.extract_feat(img, generator)
            losses = self._decode_train(x, gt_semantic_seg, generator,
                                        points)
            for prefix, head in self._aux_heads():
                losses.update(add_prefix(
                    head.losses(head(x, generator), gt_semantic_seg),
                    prefix))
        return losses, feats

    def forward_feats(self, img, capture=None):
        """The taps named in ``capture`` (all if None) of one forward, the
        teacher's path."""
        with capture_taps(self, capture) as feats:
            self(img)
        return feats

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
