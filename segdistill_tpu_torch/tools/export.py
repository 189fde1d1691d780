"""Serving export: a segmentor -> one ``torch.export`` program (counterpart
of ``tools/export_stablehlo.py`` at the root of the repository).

    python -m segdistill_tpu_torch.tools.export <config> [checkpoint]
        [--output model.pt2] [--shape H W] [--batch B] [--logits]
        [--graph graph.txt] [--device cuda] [--options KEY=VALUE ...]

exports ``argmax(encode_decode(img))`` as int32 labels (B, H, W), or the
fp32 logits (B, classes, H, W) with ``--logits``, for one NCHW float32
input of ``(batch, 3, H, W)``, with the weights in the program, and writes
it with ``torch.export.save``. For a distillation config the student alone
is exported, as ``apis.init_segmentor`` serves it; ``--options`` edits the
config as the other command lines' do (``model.backbone.fused_attention=
True`` runs the attention through K2). The hand-written serving
kernels are custom operators (``segdistill::resize_sum``,
``segdistill::layer_norm``, ``segdistill::sra_attention`` under
``fused_attention=True``), so the program holds each call as one node and
runs the kernels on the card. ``--graph`` also writes the graph's code as
text.

A program loads in a process that imports ``torch`` and
``segdistill_tpu_torch.ops`` (which registers the operators) and nothing
else of this package::

    import torch, segdistill_tpu_torch.ops
    program = torch.export.load('model.pt2').module()
    with torch.no_grad():
        labels = program(img)

Unlike the JAX tool, the program is exported on one device (``--device``,
the card by default) and has no ``--platforms``.
"""

import argparse
import os

import torch
from torch import nn

from .. import DictAction
from ..apis import init_segmentor
from ..utils import get_root_logger


class Serving(nn.Module):
    """``encode_decode`` and, unless ``logits``, the argmax over classes
    as int32 (the JAX export's output types)."""

    def __init__(self, model, logits=False):
        super().__init__()
        self.model = model
        self.logits = logits

    def forward(self, img):
        out = self.model.encode_decode(img)
        if self.logits:
            return out
        return out.argmax(dim=1).to(torch.int32)


def export_model(model, shape, logits=False):
    """-> the ``torch.export.ExportedProgram`` of :class:`Serving` for an
    NCHW float32 input of ``shape``, traced on the model's device in eval
    mode without gradients; a distillation model exports its student."""
    target = getattr(model, 'student', model).eval()
    device = next(target.parameters()).device
    img = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(Serving(target, logits), (img,))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Export a segmentor with '
                                     'torch.export')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None,
                        help='.pth file (optional)')
    parser.add_argument('--output', default='model.pt2')
    parser.add_argument('--shape', type=int, nargs=2, default=[512, 512],
                        metavar=('H', 'W'))
    parser.add_argument('--batch', type=int, default=1)
    parser.add_argument('--logits', action='store_true',
                        help='export fp32 logits instead of the argmax map')
    parser.add_argument('--graph', default=None,
                        help='also write the graph\'s code as text here')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--options', nargs='+', action=DictAction,
                        help='custom options: key=value')
    return parser.parse_args(argv)


def main(argv=None):
    """Export as the arguments say; -> the ExportedProgram."""
    args = parse_args(argv)
    logger = get_root_logger()
    model = init_segmentor(args.config, args.checkpoint, device=args.device,
                           cfg_options=args.options)
    shape = (args.batch, 3, *args.shape)
    program = export_model(model, shape, logits=args.logits)
    torch.export.save(program, args.output)
    size = os.path.getsize(args.output)
    device = next(model.parameters()).device
    logger.info(f'exported {shape} -> {args.output} ({size / 1e6:.1f} MB, '
                f'device={device})')
    if args.graph:
        with open(args.graph, 'w') as f:
            f.write(program.graph_module.code)
        logger.info(f'graph code -> {args.graph}')
    return program


if __name__ == '__main__':
    main()
