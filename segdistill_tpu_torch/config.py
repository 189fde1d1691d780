"""mmcv-style Python-file config system.

Preserves the declarative surface of the reference framework
(ref: mmcv ``Config.fromfile`` as used by ``tools/train.py:67-69`` and every
file under ``local_configs/``): ``_base_`` inheritance lists, ``_delete_=True``
dict replacement, attribute access, CLI ``--options key=val`` merge, and
``cfg.dump()`` for work-dir reproducibility.

Implemented from the documented contract, not ported from mmcv. The port's
own copy of ``segdistill_tpu/config.py``: the files under ``configs/`` are
data shared by both packages, and they build their model dicts with
``from segdistill_tpu.zoo import ...``; this loader reads that line as the
port's :mod:`segdistill_tpu_torch.zoo` (the same plain-dict recipes), so
reading a config imports nothing of the JAX package.
"""

import ast
import argparse
import copy
import os
import os.path as osp
import re
import sys
import tempfile
import types
from importlib import import_module

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'
RESERVED_KEYS = ('filename', 'text')
# the configs' model recipes: served from the port's own copy
_ZOO_IMPORT = re.compile(r'^(\s*from\s+)segdistill_tpu\.zoo(\s+import\b)',
                         re.M)


class ConfigDict(dict):
    """dict with attribute access and nice missing-key errors."""

    def __missing__(self, name):
        raise KeyError(name)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        new = ConfigDict()
        memo[id(self)] = new
        for k, v in self.items():
            new[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return new


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _validate_py_syntax(filename):
    with open(filename) as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f'There are syntax errors in config file '
                          f'{filename}: {e}')


def _file2dict(filename):
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    ext = osp.splitext(filename)[1]
    if ext != '.py':
        raise OSError('Only .py config files are supported')
    _validate_py_syntax(filename)

    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp_file = tempfile.NamedTemporaryFile(
            dir=tmp_dir, suffix='.py', delete=False)
        tmp_name = osp.basename(tmp_file.name)
        with open(filename) as f:
            source = f.read()
        tmp_file.write(_ZOO_IMPORT.sub(r'\1segdistill_tpu_torch.zoo\2',
                                       source).encode())
        tmp_file.close()
        tmp_module_name = osp.splitext(tmp_name)[0]
        sys.path.insert(0, tmp_dir)
        try:
            mod = import_module(tmp_module_name)
            cfg_dict = {
                k: v
                for k, v in mod.__dict__.items()
                if not k.startswith('__')
                and not isinstance(v, types.ModuleType)
                and not isinstance(v, types.FunctionType)
            }
            # deep-copy out of the module before it is deleted
            cfg_dict = copy.deepcopy(cfg_dict)
            del sys.modules[tmp_module_name]
        finally:
            sys.path.pop(0)

    with open(filename) as f:
        cfg_text = filename + '\n' + f.read()

    if BASE_KEY in cfg_dict:
        cfg_dir = osp.dirname(filename)
        base_filenames = cfg_dict.pop(BASE_KEY)
        if isinstance(base_filenames, str):
            base_filenames = [base_filenames]

        cfg_dict_list, cfg_text_list = [], []
        for base in base_filenames:
            _cfg_dict, _cfg_text = _file2dict(osp.join(cfg_dir, base))
            cfg_dict_list.append(_cfg_dict)
            cfg_text_list.append(_cfg_text)

        base_cfg_dict = {}
        for c in cfg_dict_list:
            dup = set(base_cfg_dict.keys()) & set(c.keys())
            if dup:
                raise KeyError(f'Duplicate keys in base configs: {dup}')
            base_cfg_dict.update(c)

        cfg_dict = merge_dict(base_cfg_dict, cfg_dict)
        cfg_text = '\n'.join(cfg_text_list + [cfg_text])

    return cfg_dict, cfg_text


def merge_dict(base, override):
    """Merge ``override`` into ``base`` (returns a new dict).

    dict values merge recursively unless the override dict carries
    ``_delete_=True``, which replaces the base value wholesale
    (the reference's ``_delete_`` contract, e.g.
    ``local_configs/exp_tab5/segformer_CGD.py:60``).
    """
    base = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and k in base and isinstance(base[k], dict) \
                and not v.pop(DELETE_KEY, False):
            base[k] = merge_dict(base[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            base[k] = copy.deepcopy(v)
    return base


class Config:
    """A facade over the merged config dict."""

    @staticmethod
    def fromfile(filename):
        cfg_dict, cfg_text = _file2dict(filename)
        return Config(cfg_dict, cfg_text=cfg_text, filename=filename)

    @staticmethod
    def fromstring(cfg_str, file_format='.py'):
        with tempfile.NamedTemporaryFile(
                'w', suffix=file_format, delete=False) as f:
            f.write(cfg_str)
            fname = f.name
        try:
            cfg = Config.fromfile(fname)
        finally:
            os.remove(fname)
        return cfg

    def __init__(self, cfg_dict=None, cfg_text=None, filename=None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f'cfg_dict must be a dict, got {type(cfg_dict)}')
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f'{key} is reserved for config file access')
        super().__setattr__('_cfg_dict', _to_config_dict(cfg_dict))
        super().__setattr__('_filename', filename)
        super().__setattr__('_text', cfg_text or '')

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f'Config (path: {self._filename}): {self._cfg_dict!r}'

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def copy(self):
        return Config(copy.deepcopy(dict(self._cfg_dict)),
                      cfg_text=self._text, filename=self._filename)

    def merge_from_dict(self, options):
        """Merge CLI ``--options a.b.c=v`` style overrides.

        ref contract: ``tools/train.py:67-69`` (``cfg.merge_from_dict``).
        """
        option_cfg = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for subkey in keys[:-1]:
                d = d.setdefault(subkey, {})
            d[keys[-1]] = v
        merged = merge_dict(dict(self._cfg_dict), option_cfg)
        super().__setattr__('_cfg_dict', _to_config_dict(merged))

    @property
    def pretty_text(self):
        import pprint
        return pprint.pformat(dict(self._cfg_dict), width=100, sort_dicts=False)

    def dump(self, file=None):
        """Dump merged config as an executable python file."""
        content = []
        for k, v in self._cfg_dict.items():
            content.append(f'{k} = {v!r}')
        text = '\n'.join(content) + '\n'
        if file is None:
            return text
        with open(file, 'w') as f:
            f.write(text)


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VAL`` pairs into a dict.

    Values are parsed as python literals when possible, with the reference's
    extra handling of booleans and comma-separated lists
    (ref contract: ``tools/train.py:49``).
    """

    @staticmethod
    def _parse_value(val):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        if val.lower() in ('true', 'false'):
            return val.lower() == 'true'
        if ',' in val:
            return [DictAction._parse_value(v) for v in val.split(',')]
        return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, val = kv.split('=', maxsplit=1)
            options[key] = self._parse_value(val)
        setattr(namespace, self.dest, options)
