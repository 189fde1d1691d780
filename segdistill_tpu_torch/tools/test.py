"""Evaluation command line (counterpart of ``tools/test.py`` at the root of
the repository; reference ``tools/test.py``).

    python -m segdistill_tpu_torch.tools.test <config> [checkpoint] --eval mIoU

evaluates the config's model (the student of a distillation config) on
``data.test``. ``checkpoint`` is a reference-layout ``.pth`` file, or a
training work dir, its ``checkpoints/`` dir or one ``iter_<n>.pth`` of it.
It prints the metrics dict on the last line and runs on the GPU unless
``--device cpu`` is given. ``--show-dir D`` also writes every image with
its prediction painted over it to ``D/<image name>.png``. With ``--multi-host`` under torchrun (as
``tools.train``) each rank evaluates its share of the images and the
ranks' class histograms are summed (``apis.fast_evaluate``); rank 0
prints the metrics of the whole dataset.
"""

import argparse
import os.path as osp

from .. import Config, DictAction
from ..apis import fast_evaluate, init_segmentor, single_device_test
from ..datasets import build_dataset
from ..engine import checkpoint_file, load_meta
from ..parallel import is_main_process
from ..utils import get_root_logger
from .train import multi_host


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test a segmentor')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None,
                        help='.pth file, or a training work dir')
    parser.add_argument('--eval', type=str, nargs='+', default=['mIoU'])
    parser.add_argument('--aug-test', action='store_true',
                        help='multi-scale and flip test-time augmentation')
    parser.add_argument('--show-dir', help='dir to save painted results')
    parser.add_argument('--options', nargs='+', action=DictAction)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--multi-host', action='store_true',
                        help="evaluate across torchrun's processes, each "
                             'its share of the images')
    return parser.parse_args(argv)


def main(argv=None):
    """Evaluate as the arguments say; -> the metrics dict."""
    args = parse_args(argv)
    if args.multi_host and args.show_dir:
        raise SystemExit('--show-dir paints in one process; run it without '
                         '--multi-host')
    with multi_host(args):
        return _test(args)


def _test(args):
    cfg = Config.fromfile(args.config)
    if args.options is not None:
        cfg.merge_from_dict(args.options)
    if args.aug_test:
        # the reference hardcodes these ratios (tools/test.py:90-108)
        pipe = cfg.data['test']['pipeline'][1]
        pipe['img_ratios'] = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
        pipe['flip'] = True
    logger = get_root_logger()

    checkpoint, meta = args.checkpoint, None
    if checkpoint is not None and (osp.isdir(checkpoint) or osp.basename(
            checkpoint).startswith('iter_')):
        meta = load_meta(checkpoint)
        checkpoint = checkpoint_file(checkpoint)
    model = init_segmentor(cfg, checkpoint, device=args.device)
    dataset = build_dataset(cfg.data['test'], dict(test_mode=True))

    # CLASSES and PALETTE from the checkpoint's meta, else the dataset's
    # (ref tools/test.py:131-135)
    if meta and meta.get('CLASSES'):
        model.CLASSES = meta['CLASSES']
        model.PALETTE = meta.get('PALETTE')
        logger.info(f'CLASSES/PALETTE read from the checkpoint meta '
                    f'({len(model.CLASSES)} classes)')
    else:
        if args.checkpoint and osp.isdir(args.checkpoint):
            logger.warning('the checkpoint has no meta; using the '
                           "dataset's CLASSES/PALETTE")
        model.CLASSES = dataset.CLASSES
        model.PALETTE = dataset.PALETTE

    if args.multi_host:
        metrics = fast_evaluate(model, dataset, metric=args.eval[0])
    else:
        results = single_device_test(model, dataset, out_dir=args.show_dir)
        metrics = dataset.evaluate(results, metric=args.eval[0],
                                   logger=logger)
    logger.info(f'Eval results: {metrics}')
    if is_main_process():
        print(metrics)
    return metrics


if __name__ == '__main__':
    main()
