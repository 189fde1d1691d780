from .builder import PIPELINES
from . import pipelines  # noqa: F401 (registers the transforms)

__all__ = ['PIPELINES']
