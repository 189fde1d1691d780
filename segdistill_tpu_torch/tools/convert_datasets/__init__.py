"""Dataset converters (counterparts of ``tools/convert_datasets/*.py`` at
the root of the repository), each a command:

    python -m segdistill_tpu_torch.tools.convert_datasets.<name> ...

for ``cityscapes``, ``medical``, ``voc_aug``, ``pascal_context`` and
``coco_stuff10k``. They write PNG with the port's own encoder
(``utils/image.py``) and import neither OpenCV nor pillow to do it
(OpenCV only to read a source image that is not PNG, such as JPEG or TIFF).
"""
