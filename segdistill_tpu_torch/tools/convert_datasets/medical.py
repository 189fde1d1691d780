"""Retinal-vessel datasets: CHASE_DB1, DRIVE, HRF and STARE (counterpart of
``tools/convert_datasets/medical.py``; reference
``tools/convert_datasets/{chase_db1,drive,hrf,stare}.py``). Unpacks the
official archives (or links a directory's files), writes the images as PNG
under ``images/{training,validation}`` and the annotations binarised to
{0 background, 1 vessel} under ``annotations/``; the first ``SPLITS[name]``
pairs are the training set.

    python -m segdistill_tpu_torch.tools.convert_datasets.medical \
        drive training.zip test.zip -o data/DRIVE

PNG sources need no OpenCV; TIFF, GIF and PPM are read with it.
"""

import argparse
import os
import os.path as osp
import tarfile
import zipfile

import numpy as np

from ...utils import image as imutil

SPLITS = {'chase_db1': 8, 'drive': 20, 'hrf': 15, 'stare': 10}


def _extract(archive, out):
    if archive.endswith('.zip'):
        with zipfile.ZipFile(archive) as z:
            z.extractall(out)
    else:
        with tarfile.open(archive) as t:
            t.extractall(out)


def _collect(directory, suffixes):
    out = []
    for root, _, files in os.walk(directory):
        out += [osp.join(root, f) for f in files
                if f.lower().endswith(suffixes)]
    return sorted(out)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert a retinal-vessel dataset')
    parser.add_argument('dataset', choices=sorted(SPLITS))
    parser.add_argument('images', help='image archive or directory')
    parser.add_argument('annotations', help='annotation archive or dir')
    parser.add_argument('-o', '--out_dir', required=True)
    return parser.parse_args(argv)


def main(argv=None):
    """Convert as the arguments say; -> the number of pairs written."""
    args = parse_args(argv)
    tmp = osp.join(args.out_dir, '_raw')
    for src, sub in [(args.images, 'img'), (args.annotations, 'ann')]:
        dst = osp.join(tmp, sub)
        os.makedirs(dst, exist_ok=True)
        if osp.isdir(src):
            for f in os.listdir(src):
                os.symlink(osp.abspath(osp.join(src, f)), osp.join(dst, f))
        else:
            _extract(src, dst)
    imgs = _collect(osp.join(tmp, 'img'),
                    ('.jpg', '.png', '.tif', '.ppm', '.gif'))
    anns = _collect(osp.join(tmp, 'ann'),
                    ('.png', '.tif', '.gif', '.ppm', '.ah'))
    assert imgs and len(imgs) == len(anns), (len(imgs), len(anns))

    n_train = SPLITS[args.dataset]
    for split in ('training', 'validation'):
        os.makedirs(osp.join(args.out_dir, 'images', split), exist_ok=True)
        os.makedirs(osp.join(args.out_dir, 'annotations', split),
                    exist_ok=True)
    for i, (im, an) in enumerate(zip(imgs, anns)):
        split = 'training' if i < n_train else 'validation'
        name = f'{osp.splitext(osp.basename(im))[0]}.png'
        imutil.imwrite(imutil.imread(im),
                       osp.join(args.out_dir, 'images', split, name))
        ann = imutil.imread(an, flag='grayscale')
        imutil.imwrite((ann > 127).astype(np.uint8),
                       osp.join(args.out_dir, 'annotations', split, name))
    print(f'{args.dataset}: wrote {len(imgs)} image/annotation pairs '
          f'({n_train} train)')
    return len(imgs)


if __name__ == '__main__':
    main()
