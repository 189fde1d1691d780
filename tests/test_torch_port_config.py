"""The port's own copies of the JAX package's framework-free modules, each
held against its original: ``config.py`` (every file under ``configs/``
loads to the same dict and text through both ``Config.fromfile``s, the
port's reading a config's ``from segdistill_tpu.zoo import`` as its own
``zoo``), ``zoo.py`` (every public function, same arguments, equal dicts),
``core/evaluation/class_names.py`` (every table and lookup) and
``registry.py`` (registration, ``build_from_cfg`` and their errors).
Equality is exact: these are plain Python values.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import pytest
from segdistill_tpu import config as jax_config
from segdistill_tpu import registry as jax_registry
from segdistill_tpu import zoo as jax_zoo
from segdistill_tpu.core.evaluation import class_names as jax_names

from segdistill_tpu_torch import config as port_config
from segdistill_tpu_torch import registry as port_registry
from segdistill_tpu_torch import zoo as port_zoo
from segdistill_tpu_torch.core.evaluation import class_names as port_names

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / 'configs').rglob('*.py'))


# beside the defaults: every MiT variant, and each optional argument set
ZOO_CALLS = {
    'segformer': [((), {})] + [((v,), {}) for v in
                               ('b1', 'b2', 'b3', 'b4', 'b5')] + [
        (('b0',), dict(num_classes=19, pretrained='a.pth', embed_dim=64,
                       dtype='bfloat16'))],
    'swin_tiny_upernet': [((), {}), ((19, 'a.pth'), {})],
    'pspnet_r50': [((), {}), ((19,), dict(depth=101, pretrained='a.pth'))],
    'psanet_r50': [((), {}), ((19,), dict(depth=101, pretrained='a.pth'))],
    'pointrend_r50': [((), {}), ((19, 'a.pth'), {})],
    'distill_entry': [(('CGDLoss',), {}),
                      (('PDLoss', dict(tau=2)),
                       dict(student_layer='a', teacher_layer='b'))],
    'sd_model': [((dict(a=1), dict(b=2), [dict(c=3)]), {}),
                 ((dict(a=1), dict(b=2), []),
                  dict(t_pretrain=None, s_pretrain='s.pth'))],
}


def _plain(obj):
    """Nested ConfigDicts as builtin containers (the two packages' dict
    classes differ; their contents must not)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _public_functions(module):
    return {name: fn for name, fn in vars(module).items()
            if inspect.isfunction(fn) and not name.startswith('_')
            and fn.__module__ == module.__name__}


def test_every_config_file_is_found():
    assert len(CONFIGS) >= 100 and \
        'configs/exp_tab5/segformer_CGD.py' in CONFIGS


@pytest.mark.parametrize('path', CONFIGS)
def test_config_loads_as_in_jax(path):
    want = jax_config.Config.fromfile(str(ROOT / path))
    got = port_config.Config.fromfile(str(ROOT / path))
    assert _plain(got._cfg_dict) == _plain(want._cfg_dict)
    assert got.text == want.text and got.filename == want.filename
    assert type(got._cfg_dict) is port_config.ConfigDict


def test_config_merge_copy_and_dict_action_as_in_jax():
    path = str(ROOT / 'configs/exp_tab5/segformer_CGD.py')
    options = {'model.cfg_s.backbone.dtype': 'bfloat16',
               'data.samples_per_gpu': 4, 'model.t_pretrain': None,
               'new.key.path': [1, 2]}
    cfgs = []
    for mod in (jax_config, port_config):
        cfg = mod.Config.fromfile(path)
        merged = cfg.copy()
        merged.merge_from_dict(options)
        assert cfg.data['samples_per_gpu'] != 4       # the copy is deep
        cfgs.append(merged)
        with pytest.raises(AttributeError):
            cfg.model.no_such_key
    assert _plain(cfgs[1]._cfg_dict) == _plain(cfgs[0]._cfg_dict)
    assert cfgs[1].pretty_text == cfgs[0].pretty_text
    for val in ('3', '0.5', 'True', 'None', 'abc', '1,2,3', '(64,64)',
                '[a,b]'):
        assert port_config.DictAction._parse_value(val) == \
            jax_config.DictAction._parse_value(val), val


def test_config_reads_zoo_imports_as_the_ports_own():
    """Loading a config that says ``from segdistill_tpu.zoo import`` must
    import nothing of the JAX package."""
    code = ('import sys\n'
            'from segdistill_tpu_torch import Config\n'
            "cfg = Config.fromfile('configs/exp_tab5/segformer_CGD.py')\n"
            "assert cfg.model['type'] == 'SDModule'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'segdistill_tpu')]\n"
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_zoo_has_the_jax_functions():
    want, got = _public_functions(jax_zoo), _public_functions(port_zoo)
    assert sorted(got) == sorted(want) and len(want) >= 5
    for name in want:
        assert inspect.signature(got[name]) == \
            inspect.signature(want[name]), name
    constants = [k for k, v in vars(jax_zoo).items()
                 if k.isupper() and not k.startswith('_')]
    assert len(constants) >= 4
    for k in constants:
        assert getattr(port_zoo, k) == getattr(jax_zoo, k), k


@pytest.mark.parametrize('name', sorted(_public_functions(jax_zoo)))
def test_zoo_function_matches_jax(name):
    """Called with its defaults where it has them, else with the arguments
    ``ZOO_CALLS`` lists: the two packages return equal dicts."""
    want_fn = _public_functions(jax_zoo)[name]
    got_fn = _public_functions(port_zoo)[name]
    for args, kwargs in ZOO_CALLS.get(name, [((), {})]):
        assert got_fn(*args, **kwargs) == want_fn(*args, **kwargs), \
            (name, args, kwargs)


@pytest.mark.parametrize('table', ['cityscapes', 'ade', 'voc'])
def test_class_names_match_jax(table):
    for kind in ('classes', 'palette'):
        want = getattr(jax_names, f'{table}_{kind}')()
        got = getattr(port_names, f'{table}_{kind}')()
        assert got == want and len(got) > 0
    for fn in ('get_classes', 'get_palette'):
        assert getattr(port_names, fn)(table) == \
            getattr(jax_names, fn)(table)


def test_class_names_lookup_errors_as_in_jax():
    assert port_names._ALIASES == jax_names._ALIASES
    for alias in jax_names._ALIASES:
        assert port_names.get_classes(alias.upper()) == \
            jax_names.get_classes(alias)
        assert port_names.get_palette(alias) == jax_names.get_palette(alias)
    for mod in (jax_names, port_names):
        with pytest.raises(ValueError, match='Unrecognized dataset'):
            mod.get_classes('no_such_dataset')
        with pytest.raises(ValueError, match='Unrecognized dataset'):
            mod.get_palette('no_such_dataset')


def test_registry_behaves_as_in_jax():
    seen = []
    for mod in (jax_registry, port_registry):
        reg = mod.Registry('thing')

        @reg.register_module()
        class Box:
            def __init__(self, a, b=2):
                self.a, self.b = a, b

        @reg.register_module(name='Other')
        class Named:
            def __init__(self, **kw):
                self.kw = kw

        box = mod.build_from_cfg(dict(type='Box', a=1), reg, dict(b=5, a=9))
        other = mod.build_from_cfg(dict(type='Other', x=1), reg)
        direct = mod.build_from_cfg(dict(type=Box, a=3), reg)
        assert (box.a, box.b, other.kw, direct.a) == (1, 5, {'x': 1}, 3)
        assert reg.get('Box') is Box and reg.get('Nope') is None
        assert 'Box' in reg and len(reg) == 2 and reg.name == 'thing'
        errors = []
        for bad in (dict(a=1), dict(type='Nope'), 'Box', dict(type=3)):
            with pytest.raises((KeyError, TypeError)) as err:
                mod.build_from_cfg(bad, reg)
            errors.append((type(err.value), str(err.value)))
        with pytest.raises(KeyError) as err:
            reg.register_module()(Box)
        errors.append((type(err.value), str(err.value)))
        seen.append((repr(reg), errors))
    assert seen[0] == seen[1]
