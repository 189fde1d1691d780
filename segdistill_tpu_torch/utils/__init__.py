from .collect_env import collect_env
from .logger import get_root_logger

__all__ = ['collect_env', 'get_root_logger']
