"""Environment report (counterpart of ``segdistill_tpu/utils/collect_env.py``;
reference ``mmseg/utils/collect_env.py``): torch, CUDA and the cards in
place of the JAX fields, the processes of the run (the world size, 1
without a process group, and the group's backend), g++'s version and
whether the native loader's core (``native/fastaug.cpp``) is already built
for this source and CPU (the report builds nothing: ``loader_backend=
'native'`` builds the core at first use)."""

import platform
import subprocess
import sys


def _gxx_version():
    try:
        res = subprocess.run(['g++', '--version'], capture_output=True,
                             text=True)
    except FileNotFoundError:
        return None
    return res.stdout.splitlines()[0] if res.returncode == 0 else None


def _fastaug_state(gxx):
    from ..native import fastaug_built
    if not gxx:
        return 'not built (no g++)'
    built = fastaug_built()
    return str(built) if built else 'not built (built at first use)'


def collect_env():
    import numpy as np
    import torch

    import torch.distributed as dist

    from .. import __version__
    from ..parallel import get_dist_info

    cuda = torch.cuda.is_available()
    gxx = _gxx_version()
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
        'World size': get_dist_info()[1],
        'Backend': dist.get_backend() if dist.is_initialized() else None,
        'GCC': gxx,
        'fastaug': _fastaug_state(gxx),
        'SegDistillTorch': __version__,
    }
