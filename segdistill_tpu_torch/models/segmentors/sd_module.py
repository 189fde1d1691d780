"""SDModule: a trainable student and a frozen teacher (counterpart of
``segdistill_tpu/models/segmentors/sd_module.py:86-178``; reference
``mmseg/models/segmentors/SD_structure.py:18-223``).

The teacher is frozen: its parameters do not require grad, it stays in
eval mode whatever ``train()`` says, and its forward runs under
``torch.no_grad()``. The step counter that drives the loss schedules and
the channel shuffle is an argument of ``forward_train``, as in the JAX
package (the reference mutates ``cnt``). Cross-width pairs get trainable
1x1 channel adapters (``distill_adapters``), trained with the student.
Inference delegates to the student. ``log_grad`` (set by a ``log_grad`` key
in the first distillation entry) asks the train step for the angle between
the segmentation and the distillation gradients.

:class:`SDModuleMT` (``sd_module.py:182-307`` of the JAX package; reference
``SD_structure.py:226-355``) distils from several frozen teachers: entry i
of the distillation list pairs with teacher i (the aligned path), or one
entry against many teachers runs one teacher a step (the random ensemble).
"""

import torch
from torch import nn

from ...distill import DistillationLoss, build_adapters, needed_layers
from .. import builder
from ..builder import SEGMENTORS
from .base import BaseSegmentor


class _Distiller(BaseSegmentor):
    """What a distillation module serves: its student's inference."""

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


@SEGMENTORS.register_module()
class SDModule(_Distiller):

    def __init__(self, cfg_s, cfg_t, train_cfg=None, test_cfg=None,
                 distillation=None, s_pretrain=None, t_pretrain=None,
                 dtype=None, pretrained=None):
        super().__init__()
        del dtype, pretrained  # student/teacher weights come via *_pretrain
        self.distillation = list(distillation or [])
        self.log_grad = bool(self.distillation
                             and 'log_grad' in self.distillation[0])
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



def draw_teacher_index(seed, n):
    """The random ensemble's teacher of a step: an index below ``n`` drawn
    on the host from a ``torch.Generator`` seeded with ``seed`` (the train
    step passes ``step_seed(seed, step)``, its generator's seed), so that
    choosing a branch needs no device sync. The JAX package draws it with
    ``jax.random.randint(fold_in(shuffle_rng, step), (), 0, n)``, which the
    port cannot reproduce: a parity test injects that index."""
    gen = torch.Generator().manual_seed(int(seed))
    return int(torch.randint(n, (), generator=gen))


@SEGMENTORS.register_module()
class SDModuleMT(_Distiller):
    """A trainable student and a list of frozen teachers (``cfg_t`` and
    ``t_pretrain`` are lists; ref SD_structure.py:226-355).

    Two dispatch modes, as in the reference's DistillationLossMT
    (opts.py:184-209) and the JAX package:

    * aligned (as many entries as teachers, or more than one entry): entry
      i reads teacher i's tap, its ``teacher_layer`` with ``str(i)``
      appended, and its loss key is ``loss_{s}<->{t}{i}_{i}``;
    * random ensemble (one entry, several teachers): one
      :class:`DistillationLoss` a teacher; each step runs the forward and
      the loss of one teacher only, logged as ``'loss_random'``.

    The teachers are frozen as SDModule's teacher is; ``distill_adapters``
    holds one ``adapter_{i}`` per entry with ``channel_nums`` (the random
    ensemble's single entry applies ``adapter_0`` against every teacher).
    """

    def __init__(self, cfg_s, cfg_t, train_cfg=None, test_cfg=None,
                 distillation=None, s_pretrain=None, t_pretrain=None,
                 dtype=None, pretrained=None):
        super().__init__()
        del dtype, pretrained  # student/teacher weights come via *_pretrain
        self.distillation = list(distillation or [])
        self.log_grad = bool(self.distillation
                             and 'log_grad' in self.distillation[0])
        self.s_pretrain = s_pretrain
        self.t_pretrain = t_pretrain
        cfg_s = dict(cfg_s)
        self.student_pretrained = cfg_s.pop('pretrained', None)
        self.student = builder.build_segmentor(cfg_s, train_cfg=train_cfg,
                                               test_cfg=test_cfg)
        teachers = []
        for c in cfg_t:
            c = dict(c)
            c.pop('pretrained', None)  # ref SD_structure.py:33
            teachers.append(builder.build_segmentor(
                c, train_cfg=train_cfg, test_cfg=test_cfg))
        self.teachers = nn.ModuleList(teachers)
        self.teachers.requires_grad_(False)
        self.teachers.eval()
        self.student_layers, base_layers = needed_layers(self.distillation)
        self.random_ensemble = (len(self.distillation) == 1
                                and len(self.teachers) > 1)
        if self.random_ensemble:
            entry = self.distillation[0]
            self.per_teacher_losses = [
                DistillationLoss([dict(entry, teacher_layer=entry[
                    'teacher_layer'] + str(i))])
                for i in range(len(self.teachers))]
            self.teacher_layers = [[entry['teacher_layer']]] * \
                len(self.teachers)
            entries = []
        else:
            entries = [dict(entry, teacher_layer=entry['teacher_layer']
                            + str(i), loss_info=str(i))
                       for i, entry in enumerate(self.distillation)]
            # teacher i feeds entry i alone
            self.teacher_layers = [base_layers[i:i + 1]
                                   for i in range(len(self.teachers))]
        self.distillation_loss = DistillationLoss(entries)
        self.distill_adapters = build_adapters(self.distillation)
        self.test_cfg = test_cfg or {}
        self.align_corners = self.student.align_corners
        self.num_classes = self.student.num_classes

    @torch.no_grad()
    def init_weights(self, generator):
        """Random initialisation of the student, each teacher in turn and
        the adapters from one ``torch.Generator``."""
        self.student.init_weights(generator)
        for teacher in self.teachers:
            teacher.init_weights(generator)
        for adapter in self.distill_adapters.values():
            adapter.init_weights(generator)

    def train(self, mode=True):
        super().train(mode)
        self.teachers.eval()
        return self

    def _teacher_feats(self, i, img):
        """Teacher ``i``'s taps of one no-grad forward, each name with
        ``str(i)`` appended (ref opts.py:153-157)."""
        if not self.teacher_layers[i]:
            return {}
        with torch.no_grad():
            feats = self.teachers[i].forward_feats(img, self.teacher_layers[i])
        return {k + str(i): v for k, v in feats.items()}

    def forward_train(self, img, gt_semantic_seg, step, generator=None,
                      perm=None, teacher_index=None):
        """-> the loss dict: the student's 'decode.*' losses and, aligned,
        one ``loss_{s}<->{t}{i}_{i}`` entry per distillation entry, or, as a
        random ensemble, ``'loss_random'`` against the step's teacher:
        ``teacher_index`` or else :func:`draw_teacher_index` from the seed
        of ``generator`` (the step's). ``perm`` overrides the channel
        shuffle's draw."""
        losses, s_feats = self.student.forward_train(
            img, gt_semantic_seg, capture=self.student_layers,
            generator=generator)
        if self.random_ensemble:
            if teacher_index is None:
                if generator is None:
                    raise ValueError('the random ensemble draws its teacher '
                                     'from the step\'s generator: pass '
                                     'generator=... or teacher_index=...')
                teacher_index = draw_teacher_index(generator.initial_seed(),
                                                   len(self.teachers))
            i = int(teacher_index)
            (value,) = self.per_teacher_losses[i](
                s_feats, self._teacher_feats(i, img), gt_semantic_seg, step,
                generator=generator, perm=perm,
                adapters=self.distill_adapters).values()
            losses['loss_random'] = value.float()
        elif self.distillation:
            t_feats = {}
            for i in range(len(self.teachers)):
                t_feats.update(self._teacher_feats(i, img))
            losses.update(self.distillation_loss(
                s_feats, t_feats, gt_semantic_seg, step,
                generator=generator, perm=perm,
                adapters=self.distill_adapters))
        return losses

