"""Retinal vessel datasets (counterpart of
``segdistill_tpu/datasets/medical.py``; reference
``mmseg/datasets/{chase_db1,drive,hrf,stare}.py``): two classes,
background and vessel, ``.png`` images beside ``.png`` label maps of 0
and 1, no zero-label reduction."""

from .builder import DATASETS
from .custom import CustomDataset

_VESSEL_CLASSES = ('background', 'vessel')
_VESSEL_PALETTE = [[120, 120, 120], [6, 230, 230]]


class _VesselDataset(CustomDataset):
    CLASSES = _VESSEL_CLASSES
    PALETTE = _VESSEL_PALETTE

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.png', seg_map_suffix='.png',
                         reduce_zero_label=False, **kwargs)


@DATASETS.register_module()
class ChaseDB1Dataset(_VesselDataset):
    pass


@DATASETS.register_module()
class DRIVEDataset(_VesselDataset):
    pass


@DATASETS.register_module()
class HRFDataset(_VesselDataset):
    pass


@DATASETS.register_module()
class STAREDataset(_VesselDataset):
    pass
