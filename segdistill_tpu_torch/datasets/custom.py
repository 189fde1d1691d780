"""CustomDataset: directory or split-file datasets and their mIoU
evaluation (counterpart of ``segdistill_tpu/datasets/custom.py``; reference
``mmseg/datasets/custom.py``).

Expected layout (ref custom.py:16-47):
    data_root/img_dir/xxx{img_suffix}
    data_root/ann_dir/xxx{seg_map_suffix}
"""

import os
import os.path as osp

import numpy as np

from ..core.evaluation import eval_metrics
from ..utils import get_root_logger
from ..utils import image as imutil
from .builder import DATASETS
from .pipelines import Compose


def scandir(dir_path, suffix=None, recursive=False):
    """Yield relative file paths under ``dir_path`` (mmcv.scandir contract)."""
    for root, _, files in os.walk(dir_path):
        for f in sorted(files):
            rel = osp.relpath(osp.join(root, f), dir_path)
            if suffix is None or rel.endswith(suffix):
                yield rel
        if not recursive:
            break


@DATASETS.register_module()
class CustomDataset:

    CLASSES = None
    PALETTE = None

    def __init__(self, pipeline, img_dir, img_suffix='.jpg', ann_dir=None,
                 seg_map_suffix='.png', split=None, data_root=None,
                 test_mode=False, ignore_index=255, reduce_zero_label=False,
                 classes=None, palette=None):
        self.pipeline = Compose(pipeline)
        self.img_dir = img_dir
        self.img_suffix = img_suffix
        self.ann_dir = ann_dir
        self.seg_map_suffix = seg_map_suffix
        self.split = split
        self.data_root = data_root
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.label_map = None
        self.CLASSES, self.PALETTE = self.get_classes_and_palette(
            classes, palette)

        if self.data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(self.data_root, self.img_dir)
            if not (self.ann_dir is None or osp.isabs(self.ann_dir)):
                self.ann_dir = osp.join(self.data_root, self.ann_dir)
            if not (self.split is None or osp.isabs(self.split)):
                self.split = osp.join(self.data_root, self.split)

        self.img_infos = self.load_annotations(
            self.img_dir, self.img_suffix, self.ann_dir,
            self.seg_map_suffix, self.split)

    def __len__(self):
        return len(self.img_infos)

    def load_annotations(self, img_dir, img_suffix, ann_dir, seg_map_suffix,
                         split):
        """(ref custom.py:119-155)."""
        img_infos = []
        if split is not None:
            with open(split) as f:
                for line in f:
                    img_name = line.strip()
                    img_info = dict(filename=img_name + img_suffix)
                    if ann_dir is not None:
                        img_info['ann'] = dict(
                            seg_map=img_name + seg_map_suffix)
                    img_infos.append(img_info)
        else:
            for img in scandir(img_dir, img_suffix, recursive=True):
                img_info = dict(filename=img)
                if ann_dir is not None:
                    img_info['ann'] = dict(seg_map=img.replace(
                        img_suffix, seg_map_suffix))
                img_infos.append(img_info)
        get_root_logger().info(
            f'Loaded {len(img_infos)} images from {img_dir}')
        return img_infos

    def get_ann_info(self, idx):
        return self.img_infos[idx]['ann']

    def pre_pipeline(self, results):
        """(ref custom.py:166-174)."""
        results['seg_fields'] = []
        results['img_prefix'] = self.img_dir
        results['seg_prefix'] = self.ann_dir
        if self.custom_classes:
            results['label_map'] = self.label_map

    def __getitem__(self, idx, rng=None):
        if self.test_mode:
            return self.prepare_test_img(idx, rng)
        return self.prepare_train_img(idx, rng)

    def prepare_train_img(self, idx, rng=None):
        img_info = self.img_infos[idx]
        ann_info = self.get_ann_info(idx)
        # per-sample RNG: deterministic-by-seed augmentation independent of
        # worker-thread interleaving (the reference's per-worker-process
        # seeding, ref datasets/builder.py:155-169)
        results = dict(img_info=img_info, ann_info=ann_info, rng=rng)
        self.pre_pipeline(results)
        return self.pipeline(results)

    def prepare_test_img(self, idx, rng=None):
        img_info = self.img_infos[idx]
        results = dict(img_info=img_info, rng=rng)
        self.pre_pipeline(results)
        return self.pipeline(results)

    def get_gt_seg_maps(self, efficient_test=False):
        """The label maps of the dataset, decoded as pillow does (a palette
        PNG gives its indices; ref custom.py:306-326)."""
        for img_info in self.img_infos:
            seg_map = osp.join(self.ann_dir, img_info['ann']['seg_map'])
            if efficient_test:
                yield seg_map
            else:
                gt = imutil.imread(seg_map, flag='unchanged',
                                   backend='pillow')
                if gt.ndim == 3:
                    gt = gt[:, :, 0]
                yield gt

    def get_classes_and_palette(self, classes=None, palette=None):
        """Custom class subsetting with a label_map (ref custom.py:243-304)."""
        if classes is None:
            self.custom_classes = False
            return self.CLASSES, self.PALETTE
        self.custom_classes = True
        if isinstance(classes, str):
            with open(classes) as f:
                class_names = [line.strip() for line in f]
        elif isinstance(classes, (tuple, list)):
            class_names = list(classes)
        else:
            raise ValueError(f'Unsupported type {type(classes)} of classes')
        if self.CLASSES:
            if not set(class_names).issubset(self.CLASSES):
                raise ValueError('classes is not a subset of CLASSES.')
            self.label_map = {}
            for i, c in enumerate(self.CLASSES):
                if c not in class_names:
                    self.label_map[i] = -1
                else:
                    self.label_map[i] = class_names.index(c)
        palette = self.get_palette_for_custom_classes(class_names, palette)
        return class_names, palette

    def get_palette_for_custom_classes(self, class_names, palette=None):
        if self.label_map is not None:
            palette = []
            for old_id, new_id in sorted(self.label_map.items(),
                                         key=lambda x: x[1]):
                if new_id != -1:
                    palette.append(self.PALETTE[old_id])
            palette = type(self.PALETTE)(palette)
        elif palette is None:
            if self.PALETTE is None:
                rng = np.random.RandomState(42)
                palette = rng.randint(0, 255,
                                      size=(len(class_names), 3)).tolist()
            else:
                palette = self.PALETTE
        return palette

    def evaluate(self, results, metric='mIoU', logger=None,
                 efficient_test=False, **kwargs):
        """-> {'mIoU', 'mAcc', 'aAcc'} + per-class table in the log
        (ref custom.py:306-380)."""
        if isinstance(metric, str):
            metric = [metric]
        if not set(metric).issubset({'mIoU', 'mDice'}):
            raise KeyError(f'metric {metric} is not supported')

        eval_results = {}
        gt_seg_maps = list(self.get_gt_seg_maps(efficient_test))
        if self.CLASSES is None:
            num_classes = len(
                set(np.concatenate([np.unique(m) for m in gt_seg_maps]))
                - {self.ignore_index})
        else:
            num_classes = len(self.CLASSES)
        ret_metrics = eval_metrics(
            results, gt_seg_maps, num_classes, self.ignore_index, metric,
            label_map=self.label_map,
            reduce_zero_label=self.reduce_zero_label)
        all_acc, acc, per_class = ret_metrics[0], ret_metrics[1], \
            ret_metrics[2]
        class_names = self.CLASSES if self.CLASSES is not None else \
            tuple(range(num_classes))

        log = get_root_logger() if logger is None else logger
        header = 'IoU' if metric[0] == 'mIoU' else 'Dice'
        lines = [f'per class results:',
                 f'{"Class":<24}{header:>10}{"Acc":>10}']
        for i, name in enumerate(class_names):
            lines.append(f'{str(name):<24}{per_class[i] * 100:>10.2f}'
                         f'{acc[i] * 100:>10.2f}')
        summary_key = 'mIoU' if metric[0] == 'mIoU' else 'mDice'
        m_val = float(np.nanmean(per_class))
        m_acc = float(np.nanmean(acc))
        lines.append(f'Summary: aAcc {all_acc * 100:.2f} | '
                     f'{summary_key} {m_val * 100:.2f} | '
                     f'mAcc {m_acc * 100:.2f}')
        log.info('\n'.join(lines))

        eval_results[summary_key] = m_val
        eval_results['mAcc'] = m_acc
        eval_results['aAcc'] = float(all_acc)
        return eval_results
