"""Cityscapes: write ``*_gtFine_labelTrainIds.png`` beside every
``*_gtFine_labelIds.png`` under ``gtFine/`` (counterpart of
``tools/convert_datasets/cityscapes.py``; the reference shells out to
cityscapesscripts, this applies the official id -> train id table).

    python -m segdistill_tpu_torch.tools.convert_datasets.cityscapes \
        data/cityscapes [--gt-dir gtFine]
"""

import argparse
import os
import os.path as osp

import numpy as np

from ...utils import image as imutil

# official Cityscapes label id -> train id (255 ignored)
ID2TRAIN = np.full(256, 255, np.uint8)
for _lid, _tid in [(7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5),
                   (19, 6), (20, 7), (21, 8), (22, 9), (23, 10), (24, 11),
                   (25, 12), (26, 13), (27, 14), (28, 15), (31, 16),
                   (32, 17), (33, 18)]:
    ID2TRAIN[_lid] = _tid


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert Cityscapes label ids to train ids')
    parser.add_argument('cityscapes_path', help='root with gtFine/')
    parser.add_argument('--gt-dir', default='gtFine')
    return parser.parse_args(argv)


def main(argv=None):
    """Convert every label-id map; -> the number converted."""
    args = parse_args(argv)
    count = 0
    for root, _, files in os.walk(osp.join(args.cityscapes_path,
                                           args.gt_dir)):
        for f in sorted(files):
            if not f.endswith('_labelIds.png'):
                continue
            src = osp.join(root, f)
            label = imutil.imread(src, flag='unchanged')
            imutil.imwrite(ID2TRAIN[label],
                           src.replace('_labelIds.png',
                                       '_labelTrainIds.png'))
            count += 1
    print(f'converted {count} annotation maps')
    return count


if __name__ == '__main__':
    main()
