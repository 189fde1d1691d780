"""Environment report (counterpart of ``segdistill_tpu/utils/collect_env.py``;
reference ``mmseg/utils/collect_env.py``): torch, CUDA and the cards in
place of the JAX fields."""

import platform
import sys


def collect_env():
    import numpy as np
    import torch

    from .. import __version__

    cuda = torch.cuda.is_available()
    devices = [torch.cuda.get_device_name(i)
               for i in range(torch.cuda.device_count())] if cuda else []
    return {
        'sys.platform': sys.platform,
        'Python': sys.version.replace('\n', ''),
        'CPU': platform.processor() or platform.machine(),
        'PyTorch': torch.__version__,
        'CUDA available': cuda,
        'CUDA (torch build)': torch.version.cuda,
        'cuDNN': torch.backends.cudnn.version() if cuda else None,
        'NumPy': np.__version__,
        'Devices': ', '.join(devices) or 'cpu',
        'SegDistillTorch': __version__,
    }
