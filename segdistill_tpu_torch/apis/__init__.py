from .inference import (LoadImage, inference_segmentor, init_segmentor,
                        load_backbone_checkpoint, load_checkpoint,
                        match_checkpoint, serving_pipeline,
                        show_result_pyplot, student_config)
from .test import fast_evaluate, multi_device_test, single_device_test
from .train import (init_segmentor_state, prepare_training, set_random_seed,
                    train_segmentor)

__all__ = ['LoadImage', 'inference_segmentor', 'init_segmentor',
           'load_backbone_checkpoint', 'load_checkpoint', 'match_checkpoint',
           'show_result_pyplot', 'student_config',
           'single_device_test',
           'multi_device_test', 'fast_evaluate', 'serving_pipeline',
           'init_segmentor_state', 'prepare_training', 'set_random_seed',
           'train_segmentor']
