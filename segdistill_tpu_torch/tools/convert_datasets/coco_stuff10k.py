"""COCO-Stuff 10k (counterpart of
``tools/convert_datasets/coco_stuff10k.py``; reference
``tools/convert_datasets/coco_stuff10k.py``): reads the ``.mat``
annotations (``S``), maps the raw category ids onto contiguous train ids
(0 stays 0, the unlabeled; the 171 present ids take 1..171 in order) and
writes ``annotations/{train2014,test2014}/<name>_labelTrainIds.png`` beside
copies of the images under ``images/``, the split taken from
``imageLists/{train,test}.txt`` (10000 images in all).

    python -m segdistill_tpu_torch.tools.convert_datasets.coco_stuff10k \
        data/coco_stuff10k [-o out]
"""

import argparse
import os
import os.path as osp
import shutil

import numpy as np
from scipy.io import loadmat

from ...utils import image as imutil

COCO_LEN = 10000

# the 11 thing ids COCO-Stuff leaves out; the rest of 1..182 are its 171
# classes
_ABSENT = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
clsID_to_trID = {0: 0}
for _cls in range(1, 183):
    if _cls not in _ABSENT:
        clsID_to_trID[_cls] = len(clsID_to_trID)
assert max(clsID_to_trID.values()) == 171
_TABLE = np.arange(256, dtype=np.uint8)
for _cls, _tr in clsID_to_trID.items():
    _TABLE[_cls] = _tr


def convert_to_trainID(tuple_path, in_img_dir, in_ann_dir, out_img_dir,
                       out_mask_dir, is_train):
    imgpath, maskpath = tuple_path
    sub = 'train2014' if is_train else 'test2014'
    shutil.copyfile(osp.join(in_img_dir, imgpath),
                    osp.join(out_img_dir, sub, imgpath))
    mask = loadmat(osp.join(in_ann_dir, maskpath))['S'].astype(np.uint8)
    imutil.imwrite(_TABLE[mask], osp.join(
        out_mask_dir, sub, maskpath.split('.')[0] + '_labelTrainIds.png'))


def generate_coco_list(folder):
    """-> [train pairs, test pairs] of (image, annotation) file names."""
    out = []
    for split in ('train', 'test'):
        with open(osp.join(folder, 'imageLists', f'{split}.txt')) as f:
            out.append([(base + '.jpg', base + '.mat')
                        for base in (line.strip() for line in f) if base])
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert COCO-Stuff 10k annotations')
    parser.add_argument('coco_path', help='coco stuff path')
    parser.add_argument('-o', '--out_dir', help='output path')
    return parser.parse_args(argv)


def main(argv=None):
    """Convert as the arguments say; -> (train pairs, test pairs)."""
    args = parse_args(argv)
    out_dir = args.out_dir or args.coco_path
    out_img_dir = osp.join(out_dir, 'images')
    out_mask_dir = osp.join(out_dir, 'annotations')
    for sub in ('train2014', 'test2014'):
        os.makedirs(osp.join(out_img_dir, sub), exist_ok=True)
        os.makedirs(osp.join(out_mask_dir, sub), exist_ok=True)
    train_paths, test_paths = generate_coco_list(args.coco_path)
    assert len(train_paths) + len(test_paths) == COCO_LEN, \
        f'expected {COCO_LEN} images, got ' \
        f'{len(train_paths)}+{len(test_paths)}'
    in_img_dir = osp.join(args.coco_path, 'images')
    in_ann_dir = osp.join(args.coco_path, 'annotations')
    for paths, is_train in ((train_paths, True), (test_paths, False)):
        for i, tp in enumerate(paths):
            convert_to_trainID(tp, in_img_dir, in_ann_dir, out_img_dir,
                               out_mask_dir, is_train)
            if (i + 1) % 1000 == 0:
                print(f'{"train" if is_train else "test"}: {i + 1} done')
    print('Done!')
    return train_paths, test_paths


if __name__ == '__main__':
    main()
