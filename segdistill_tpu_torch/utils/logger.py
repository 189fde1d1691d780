"""Root logger with an optional log file (counterpart of
``segdistill_tpu/utils/logger.py``; reference ``mmseg/utils/logger.py:6-33``).
One process per run here, so there is no rank to silence. Records also
propagate to the root logger, so a caller's own handlers see them."""

import logging

_initialized = {}


def get_root_logger(log_file=None, log_level=logging.INFO,
                    name='segdistill_tpu_torch'):
    """The package's logger, with a stream handler on first use. A
    ``log_file`` is added whenever one is named and not yet attached, so a
    second run of a command line in one process logs to its own file."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    if name not in _initialized:
        stream = logging.StreamHandler()
        stream.setFormatter(fmt)
        logger.addHandler(stream)
        logger.setLevel(log_level)
        _initialized[name] = set()
    if log_file is not None and log_file not in _initialized[name]:
        fh = logging.FileHandler(log_file, 'w')
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        _initialized[name].add(log_file)
    return logger
