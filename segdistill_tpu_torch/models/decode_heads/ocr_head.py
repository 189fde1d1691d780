"""The cascade heads' base (counterpart of the base class in
``segdistill_tpu/models/decode_heads/ocr_head.py``; reference
``mmseg/models/decode_heads/cascade_decode_head.py``). ``OCRHead`` itself
is not ported yet."""

from .decode_head import BaseDecodeHead


class BaseCascadeDecodeHead(BaseDecodeHead):
    """A head that also takes the previous stage's logits:
    ``forward(inputs, prev_output, generator=None, points=None)``, where
    ``points`` (a point head's) overrides the head's own draw of its
    training points."""
