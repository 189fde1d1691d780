"""Training command line (counterpart of ``tools/train.py`` at the root of
the repository; reference ``tools/train.py``).

    python -m segdistill_tpu_torch.tools.train <config> --work-dir W

builds the model, the datasets and the loader from the config and trains
with periodic checkpoints and evaluations on ``data.val``;
``--resume-from`` continues a run from a checkpoint (a work dir, its
``checkpoints/`` dir or one ``iter_<n>.pth``), ``--load-from`` starts from
its weights alone. It runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import os
import os.path as osp
import time

from .. import Config, DictAction
from ..apis import init_segmentor_state, set_random_seed, train_segmentor
from ..datasets import build_dataset
from ..utils import collect_env, get_root_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a segmentor')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='the dir to save logs and models')
    parser.add_argument('--load-from',
                        help='checkpoint for a weights-only warm start: the '
                             'iteration counter and the optimizer state stay '
                             'fresh (ref apis/train.py:134-135)')
    parser.add_argument('--resume-from',
                        help='checkpoint to resume from: weights, optimizer '
                             'state and step. Fails if it cannot be restored')
    parser.add_argument('--no-validate', action='store_true',
                        help='skip the evaluations during training')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--deterministic', action='store_true',
                        help='ask cuDNN for deterministic algorithms')
    parser.add_argument('--options', nargs='+', action=DictAction,
                        help='custom options: key=value')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Train as the arguments say; -> the final train state."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options is not None:
        cfg.merge_from_dict(args.options)
    if args.work_dir is not None:
        cfg.work_dir = args.work_dir
    elif cfg.get('work_dir', None) is None:
        cfg.work_dir = osp.join('./work_dirs',
                                osp.splitext(osp.basename(args.config))[0])
    if args.resume_from is not None:
        cfg.resume_from = args.resume_from
    if args.load_from is not None:
        cfg.load_from = args.load_from
    if args.seed is not None:
        cfg.seed = args.seed
    seed = 42 if cfg.get('seed', None) is None else cfg.seed

    os.makedirs(osp.abspath(cfg.work_dir), exist_ok=True)
    cfg.dump(osp.join(cfg.work_dir, osp.basename(args.config)))
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    log_file = osp.join(cfg.work_dir, f'{timestamp}.log')
    n = 1
    while osp.exists(log_file):  # a second run within the same second
        log_file = osp.join(cfg.work_dir, f'{timestamp}_{n}.log')
        n += 1
    timestamp = osp.splitext(osp.basename(log_file))[0]
    logger = get_root_logger(log_file=log_file)

    env_info = '\n'.join(f'{k}: {v}' for k, v in collect_env().items())
    logger.info('Environment info:\n' + env_info)
    logger.info(f'Config:\n{cfg.pretty_text}')

    set_random_seed(seed, deterministic=args.deterministic)
    model = init_segmentor_state(cfg, seed=seed, device=args.device)
    datasets = [build_dataset(cfg.data['train'])]
    return train_segmentor(model, datasets, cfg,
                           validate=not args.no_validate,
                           timestamp=timestamp, seed=seed)


if __name__ == '__main__':
    main()
