"""CascadeEncoderDecoder: a chain of decode heads, each after the first
refining the previous stage's logits (counterpart of
``segdistill_tpu/models/segmentors/cascade_encoder_decoder.py``;
reference ``mmseg/models/segmentors/cascade_encoder_decoder.py``), the
PointRend segmentor.

``decode_head`` is an ``nn.ModuleList`` (the reference ``.pth``'s
``decode_head.{i}.*``). The forward returns the last stage's logits; in
training ``forward_train`` gives each stage's losses under
'decode_{i}.', the point head's on the points it drew or was given.
"""

from torch import nn

from .. import builder
from ..builder import SEGMENTORS
from .base import add_prefix
from .encoder_decoder import EncoderDecoder


@SEGMENTORS.register_module()
class CascadeEncoderDecoder(EncoderDecoder):

    def __init__(self, num_stages, backbone, decode_head, **kwargs):
        if num_stages != len(decode_head):
            raise ValueError(f'num_stages {num_stages} but '
                             f'{len(decode_head)} decode heads')
        self.num_stages = num_stages
        super().__init__(backbone, decode_head, **kwargs)

    def _init_decode_head(self, decode_head):
        self.decode_head = nn.ModuleList(
            builder.build_head(c) for c in decode_head)
        self.align_corners = self.decode_head[-1].align_corners
        self.num_classes = self.decode_head[-1].num_classes

    def _stages(self, x, generator, points=None):
        outs = [self.decode_head[0](x, generator)]
        for head in self.decode_head[1:]:
            outs.append(head(x, outs[-1], generator, points))
        return outs

    def forward(self, img, generator=None):
        """The last stage's logits (in eval mode the point head's refined
        map)."""
        return self._stages(self.extract_feat(img, generator), generator)[-1]

    def _decode_train(self, x, gt_semantic_seg, generator, points):
        losses = {}
        for i, (head, out) in enumerate(zip(
                self.decode_head, self._stages(x, generator, points))):
            losses.update(add_prefix(head.losses(out, gt_semantic_seg),
                                     f'decode_{i}'))
        return losses
