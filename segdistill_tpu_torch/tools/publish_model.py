"""Stamp a checkpoint for release with its content hash (counterpart of
``tools/publish_model.py`` at the root of the repository; reference
``tools/publish_model.py``).

    python -m segdistill_tpu_torch.tools.publish_model <in> <out>

copies a file or a directory to ``<out stem>-<sha256[:8]><out suffix>``:
the first 8 hex digits of the SHA-256 of its bytes (a directory's files in
sorted order of their paths).
"""

import argparse
import hashlib
import os
import shutil


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='publish a checkpoint')
    parser.add_argument('in_path', help='checkpoint dir or file')
    parser.add_argument('out_path', help='output path (hash appended)')
    return parser.parse_args(argv)


def _update(sha, path):
    with open(path, 'rb') as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b''):
            sha.update(chunk)


def hash_path(path):
    """-> the hex SHA-256 of a file's bytes, or of a directory's files in
    sorted order."""
    sha = hashlib.sha256()
    if os.path.isdir(path):
        for root, _, files in sorted(os.walk(path)):
            for f in sorted(files):
                _update(sha, os.path.join(root, f))
    else:
        _update(sha, path)
    return sha.hexdigest()


def main(argv=None):
    """Copy and name; -> the published path."""
    args = parse_args(argv)
    digest = hash_path(args.in_path)[:8]
    root, ext = os.path.splitext(args.out_path)
    final = f'{root}-{digest}{ext}'
    if os.path.isdir(args.in_path):
        shutil.copytree(args.in_path, final)
    else:
        shutil.copy2(args.in_path, final)
    print(f'published: {final}')
    return final


if __name__ == '__main__':
    main()
