from .inference import (LoadImage, inference_segmentor, init_segmentor,
                        load_checkpoint, serving_pipeline)
from .test import single_device_test

__all__ = ['LoadImage', 'inference_segmentor', 'init_segmentor',
           'load_checkpoint', 'single_device_test', 'serving_pipeline']
