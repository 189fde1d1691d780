#!/usr/bin/env python
"""Packaging (ref contract: setup.py). The native aug core builds lazily at
first use (segdistill_tpu/native/fastaug.py); no compiled ext required to
install."""

import os.path as osp
import re

from setuptools import find_packages, setup


def get_version():
    init = osp.join(osp.dirname(__file__), 'segdistill_tpu', 'version.py')
    with open(init) as f:
        return re.search(r"__version__ = '([^']+)'", f.read()).group(1)


setup(
    name='segdistill-tpu',
    version=get_version(),
    description='TPU-native knowledge-distillation framework for semantic '
                'segmentation (JAX/XLA/Pallas)',
    long_description=open('README.md').read(),
    long_description_content_type='text/markdown',
    packages=find_packages(exclude=('tests', 'tools', 'configs')),
    package_data={'segdistill_tpu': ['../native/fastaug.cpp'],
                  'segdistill_tpu_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy',
        'opencv-python',
    ],
    license='Apache License 2.0',
)
