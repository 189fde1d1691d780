"""Pascal VOC 2012 augmented with SBD (counterpart of
``tools/convert_datasets/voc_aug.py``; reference
``tools/convert_datasets/voc_aug.py``): every SBD ``dataset/cls/*.mat``
(``GTcls.Segmentation``) becomes a gray PNG of class indices under
``VOC2012/SegmentationClassAug``, and the augmented training split, the
names of SBD's ``train.txt`` and VOC's ``train.txt`` less VOC's ``val.txt``
(sorted), is written to ``VOC2012/ImageSets/Segmentation/aug.txt``: the
file ``configs/_base_/datasets/pascal_voc12_aug.py`` reads (the JAX
package's converter names it ``trainaug.txt``).

    python -m segdistill_tpu_torch.tools.convert_datasets.voc_aug \
        data/VOCdevkit data/VOCdevkit/benchmark_RELEASE
"""

import argparse
import os
import os.path as osp

import numpy as np
from scipy.io import loadmat

from ...utils import image as imutil

SPLIT_NAME = 'aug.txt'


def convert_mat(mat_file, out_dir):
    """One SBD ``.mat`` -> ``<out_dir>/<name>.png``; -> the file name."""
    seg = loadmat(mat_file)['GTcls'][0]['Segmentation'][0].astype(np.uint8)
    name = osp.splitext(osp.basename(mat_file))[0] + '.png'
    imutil.imwrite(seg, osp.join(out_dir, name))
    return name


def _names(path):
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert the SBD augmentation of Pascal VOC 2012')
    parser.add_argument('devkit_path', help='VOCdevkit root')
    parser.add_argument('aug_path', help='SBD benchmark_RELEASE root')
    return parser.parse_args(argv)


def main(argv=None):
    """Convert as the arguments say; -> the names of the split."""
    args = parse_args(argv)
    out_dir = osp.join(args.devkit_path, 'VOC2012', 'SegmentationClassAug')
    os.makedirs(out_dir, exist_ok=True)
    mat_dir = osp.join(args.aug_path, 'dataset', 'cls')
    names = [convert_mat(osp.join(mat_dir, f), out_dir)
             for f in sorted(os.listdir(mat_dir)) if f.endswith('.mat')]
    print(f'converted {len(names)} SBD annotations into {out_dir}')

    split_dir = osp.join(args.devkit_path, 'VOC2012', 'ImageSets',
                         'Segmentation')
    aug = sorted((_names(osp.join(args.aug_path, 'dataset', 'train.txt'))
                  | _names(osp.join(split_dir, 'train.txt')))
                 - _names(osp.join(split_dir, 'val.txt')))
    with open(osp.join(split_dir, SPLIT_NAME), 'w') as f:
        f.write('\n'.join(aug) + '\n')
    print(f'wrote the {SPLIT_NAME} split ({len(aug)} images)')
    return aug


if __name__ == '__main__':
    main()
