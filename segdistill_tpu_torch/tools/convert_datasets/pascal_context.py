"""Pascal Context, 60 classes (counterpart of
``tools/convert_datasets/pascal_context.py``; reference
``tools/convert_datasets/pascal_context.py``): maps the Detail API's raw
category ids onto the 60-class subset (a class's index is the rank of its
id in the sorted table) and writes a gray PNG an image under
``VOC2010/SegmentationClassContext`` and the train / val name lists under
``VOC2010/ImageSets/SegmentationContext``. Needs the ``detail`` package
(the PASCAL-in-Detail API) and ``trainval_merged.json``, as the reference
does.

    python -m segdistill_tpu_torch.tools.convert_datasets.pascal_context \
        data/VOCdevkit data/VOCdevkit/VOC2010/trainval_merged.json
"""

import argparse
import os
import os.path as osp

import numpy as np

from ...utils import image as imutil

# the 60 Pascal Context category ids (ref pascal_context.py:10-17)
_MAPPING = np.sort(np.array([
    0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22, 23, 397, 25, 284,
    158, 159, 416, 33, 162, 420, 454, 295, 296, 427, 44, 45, 46, 308, 59,
    440, 445, 31, 232, 65, 354, 424, 68, 326, 72, 458, 34, 207, 80, 355,
    85, 347, 220, 349, 360, 98, 187, 104, 105, 366, 189, 368, 113, 115]))
_KEY = np.arange(len(_MAPPING)).astype(np.uint8)


def class_to_index(mask):
    """Raw category ids -> uint8 class indices (an id outside the table
    raises)."""
    for v in np.unique(mask):
        assert v in _MAPPING, f'unexpected raw category id {v}'
    index = np.digitize(mask.ravel(), _MAPPING, right=True)
    return _KEY[index].reshape(mask.shape)


def generate_labels(img_id, detail, out_dir):
    filename = img_id['file_name']
    imutil.imwrite(class_to_index(detail.getMask(img_id)),
                   osp.join(out_dir, filename.replace('jpg', 'png')))
    return osp.splitext(osp.basename(filename))[0]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert Pascal Context annotations')
    parser.add_argument('devkit_path', help='Pascal VOC devkit path')
    parser.add_argument('json_path', help='trainval_merged.json path')
    parser.add_argument('-o', '--out_dir', help='output path')
    return parser.parse_args(argv)


def main(argv=None):
    """Convert as the arguments say; -> {split: names}."""
    args = parse_args(argv)
    try:
        from detail import Detail
    except ImportError as e:
        raise SystemExit(
            'pascal_context conversion needs the PASCAL-in-Detail API '
            '(the `detail` package, github.com/ccvl/detail-api)') from e
    out_dir = args.out_dir or osp.join(args.devkit_path, 'VOC2010',
                                       'SegmentationClassContext')
    os.makedirs(out_dir, exist_ok=True)
    img_dir = osp.join(args.devkit_path, 'VOC2010', 'JPEGImages')
    split_dir = osp.join(args.devkit_path, 'VOC2010', 'ImageSets',
                         'SegmentationContext')
    os.makedirs(split_dir, exist_ok=True)
    splits = {}
    for split in ('train', 'val'):
        detail = Detail(args.json_path, img_dir, split)
        names = sorted(generate_labels(img_id, detail, out_dir)
                       for img_id in detail.getImgs())
        with open(osp.join(split_dir, f'{split}.txt'), 'w') as f:
            f.writelines(n + '\n' for n in names)
        print(f'{split}: {len(names)} images')
        splits[split] = names
    print('Done!')
    return splits


if __name__ == '__main__':
    main()
