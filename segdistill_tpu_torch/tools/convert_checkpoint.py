"""Fit a reference ``.pth`` checkpoint to a config's model and write the
tensors that matched (counterpart of ``tools/convert_checkpoint.py`` at the
root of the repository).

    python -m segdistill_tpu_torch.tools.convert_checkpoint <config> \\
        <in.pth> <out.pth> [--backbone-only] [--role model|student|teacher]

builds the config's model (with ``--role student`` or ``teacher``, that
network of a distillation config), reads the file as ``apis``' loaders read
it (a whole model, or with ``--backbone-only`` a backbone file whose keys
may lack the ``backbone.`` prefix; DDP prefixes, the reference head's
unused ``conv_seg`` and Swin's tables fitted) and writes
``{'state_dict': ...}`` with the model's names for every tensor it took:
the reference layout, which ``apis.init_segmentor`` and the JAX package's
loader read. It logs what matched, what the model missed and what the file
had beyond it. The JAX tool writes an orbax directory instead.
"""

import argparse

import torch

from ..apis import load_backbone_checkpoint, match_checkpoint
from ..config import Config
from ..models import build_segmentor
from ..utils import get_root_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='convert a checkpoint')
    parser.add_argument('config', help='config describing the target model')
    parser.add_argument('pth', help='torch checkpoint')
    parser.add_argument('out', help='output .pth')
    parser.add_argument('--backbone-only', action='store_true')
    parser.add_argument('--role', choices=['model', 'student', 'teacher'],
                        default='model')
    return parser.parse_args(argv)


def main(argv=None):
    """Convert; -> (matched keys, missing keys, unexpected keys)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    model_cfg = dict(cfg.model)
    if model_cfg.get('type') in ('SDModule', 'SDModuleMT') \
            and args.role != 'model':
        model_cfg = dict(model_cfg['cfg_s' if args.role == 'student'
                                   else 'cfg_t'])
    model_cfg.pop('pretrained', None)
    model = build_segmentor(model_cfg)
    logger = get_root_logger()
    if args.backbone_only:
        keys, missing, unexpected = load_backbone_checkpoint(model,
                                                             args.pth)
        own = model.state_dict()
        matched = {k: own[k] for k in keys}
    else:
        matched, missing, unexpected = match_checkpoint(model, args.pth)
        logger.info(f'loaded {args.pth}: {len(matched)} tensors matched, '
                    f'{len(missing)} missing, {len(unexpected)} unexpected')
    torch.save({'state_dict': {k: v.detach().cpu().contiguous()
                               for k, v in matched.items()}}, args.out)
    logger.info(f'saved {len(matched)} tensors to {args.out}')
    return sorted(matched), missing, unexpected


if __name__ == '__main__':
    main()
