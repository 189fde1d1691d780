"""Registry: string-keyed class dispatch driving the declarative config system.

Preserves the reference's registry contract (``mmseg/models/builder.py:6-53``):
``cfg['type']`` selects a registered class, remaining keys are constructor
kwargs, ``default_args`` fill in unset keys. The port's own copy of
``segdistill_tpu/registry.py``.
"""

import inspect


class Registry:

    def __init__(self, name):
        self._name = name
        self._module_dict = {}

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={list(self._module_dict)})')

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key):
        return self._module_dict.get(key, None)

    def _register(self, cls, name=None, force=False):
        if not inspect.isclass(cls) and not inspect.isfunction(cls):
            raise TypeError(f'module must be a class or function, '
                            f'got {type(cls)}')
        name = name or cls.__name__
        names = [name] if isinstance(name, str) else name
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f'{n} is already registered in {self._name}')
            self._module_dict[n] = cls

    def register_module(self, name=None, force=False, module=None):
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator


def build_from_cfg(cfg, registry, default_args=None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **defaults)``."""
    if not isinstance(cfg, dict):
        raise TypeError(f'cfg must be a dict, got {type(cfg)}')
    if 'type' not in cfg:
        raise KeyError(f'cfg must contain the key "type", got {cfg}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} '
                           f'registry. Registered: {list(registry.module_dict)}')
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
