"""Pipeline registry, under the JAX package's type names."""

from segdistill_tpu.registry import Registry

PIPELINES = Registry('pipeline')
