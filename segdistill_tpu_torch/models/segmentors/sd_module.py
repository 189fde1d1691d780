"""SDModule: a trainable student and a frozen teacher (counterpart of
``segdistill_tpu/models/segmentors/sd_module.py:86-178``; reference
``mmseg/models/segmentors/SD_structure.py:18-223``).

The teacher is frozen: its parameters do not require grad, it stays in
eval mode whatever ``train()`` says, and its forward runs under
``torch.no_grad()``. The step counter that drives the loss schedules and
the channel shuffle is an argument of ``forward_train``, as in the JAX
package (the reference mutates ``cnt``). Cross-width pairs get trainable
1x1 channel adapters (``distill_adapters``), trained with the student.
Inference delegates to the student. The multi-teacher variant and the
gradient-angle diagnostic (``log_grad``) are not ported yet.
"""

import torch

from ...distill import DistillationLoss, build_adapters, needed_layers
from .. import builder
from ..builder import SEGMENTORS
from .base import BaseSegmentor


@SEGMENTORS.register_module()
class SDModule(BaseSegmentor):

    def __init__(self, cfg_s, cfg_t, train_cfg=None, test_cfg=None,
                 distillation=None, s_pretrain=None, t_pretrain=None,
                 dtype=None, pretrained=None):
        super().__init__()
        del dtype, pretrained  # student/teacher weights come via *_pretrain
        self.distillation = list(distillation or [])
        if any('log_grad' in entry for entry in self.distillation):
            raise NotImplementedError('log_grad (the seg/distill gradient '
                                      'angle) is not ported yet')
        self.s_pretrain = s_pretrain
        self.t_pretrain = t_pretrain
        self.student_layers, self.teacher_layers = \
            needed_layers(self.distillation)
        cfg_s = dict(cfg_s)
        # the student's backbone-only checkpoint, loaded by
        # apis.init_segmentor_state
        self.student_pretrained = cfg_s.pop('pretrained', None)
        cfg_t = dict(cfg_t)
        cfg_t.pop('pretrained', None)  # ref SD_structure.py:33
        self.student = builder.build_segmentor(cfg_s, train_cfg=train_cfg,
                                               test_cfg=test_cfg)
        self.teacher = builder.build_segmentor(cfg_t, train_cfg=train_cfg,
                                               test_cfg=test_cfg)
        self.teacher.requires_grad_(False)
        self.teacher.eval()
        self.distill_adapters = build_adapters(self.distillation)
        self.distillation_loss = DistillationLoss(self.distillation)
        self.test_cfg = test_cfg or {}
        self.align_corners = self.student.align_corners
        self.num_classes = self.student.num_classes

    @torch.no_grad()
    def init_weights(self, generator):
        """Random initialisation of student, teacher and adapters from one
        ``torch.Generator``."""
        self.student.init_weights(generator)
        self.teacher.init_weights(generator)
        for adapter in self.distill_adapters.values():
            adapter.init_weights(generator)

    def train(self, mode=True):
        super().train(mode)
        self.teacher.eval()
        return self

    def forward_train(self, img, gt_semantic_seg, step, generator=None,
                      perm=None):
        """-> the loss dict: the student's 'decode.*' losses and one
        ``loss_{s}<->{t}_{info}`` entry per distillation entry
        (SD_structure.py:61-90). ``step`` drives the loss schedules;
        ``generator`` the student's dropout and the channel shuffle's
        permutation, unless ``perm`` is given."""
        capture = self.student_layers if self.distillation else ()
        losses, s_feats = self.student.forward_train(
            img, gt_semantic_seg, capture=capture, generator=generator)
        if self.distillation:
            with torch.no_grad():
                t_feats = self.teacher.forward_feats(img,
                                                     self.teacher_layers)
            losses.update(self.distillation_loss(
                s_feats, t_feats, gt_semantic_seg, step,
                generator=generator, perm=perm,
                adapters=self.distill_adapters))
        return losses

    # inference: the student's
    def forward(self, img):
        return self.student(img)

    def encode_decode(self, img):
        return self.student.encode_decode(img)

    def whole_inference(self, img, ori_shape=None, rescale=False):
        return self.student.whole_inference(img, ori_shape, rescale)

    def slide_inference(self, img, ori_shape=None, rescale=False):
        return self.student.slide_inference(img, ori_shape, rescale)

    def inference_logits(self, img, ori_shape=None, rescale=False):
        return self.student.inference_logits(img, ori_shape, rescale)

    def inference(self, img, ori_shape=None, rescale=False, flip=False,
                  flip_direction='horizontal'):
        return self.student.inference(img, ori_shape, rescale, flip,
                                      flip_direction)

    def simple_test(self, img, ori_shape=None, rescale=True, flip=False,
                    flip_direction='horizontal'):
        return self.student.simple_test(img, ori_shape, rescale, flip,
                                        flip_direction)

    def aug_test(self, imgs, metas, rescale=True):
        return self.student.aug_test(imgs, metas, rescale)
