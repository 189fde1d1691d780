from .inference import (LoadImage, inference_segmentor, init_segmentor,
                        load_checkpoint, serving_pipeline)
from .test import single_device_test
from .train import init_segmentor_state, prepare_training, train_segmentor

__all__ = ['LoadImage', 'inference_segmentor', 'init_segmentor',
           'load_checkpoint', 'single_device_test', 'serving_pipeline',
           'init_segmentor_state', 'prepare_training', 'train_segmentor']
