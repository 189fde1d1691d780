from .misc import add_prefix

__all__ = ['add_prefix']
