"""The port's reference `.pth` import (rtseg_tpu_torch/utils/transplant.py
and tools/torch_import_reference.py) against the JAX package's
(rtseg_tpu/utils/transplant.py, tools/import_reference.py):

* the reorder helpers and every SD_REORDER fixup give JAX's order: on
  the unit lists of tests/test_transplant_units.py and on random lists
  named from the fixups' own scope names (the same result, or the same
  exception);
* `flax_leaf_order` gives JAX's Flax paths and kinds, in order, for every
  SD_REORDER model and FastSCNN (the JAX order traced under
  jax.eval_shape at a small input);
* `sd_leaf_units` + `apply_units` give the tree JAX's give, bit for bit,
  on the same seeded state dict;
* tools/torch_import_reference.py end to end on FastSCNN: the port model
  with the imported checkpoint gives the JAX model's eval logits with
  JAX's imported tree, within 1e-4, and the source model's.
"""

import functools
import inspect
import random
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.models import get_model as jax_get_model
from rtseg_tpu.utils import transplant as jt
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models import get_model
from rtseg_tpu_torch.train.checkpoint import load_meta, restore_weights
from rtseg_tpu_torch.utils import transplant as pt
from rtseg_tpu_torch.utils.convert import (_flatten, load_jax_variables,
                                           random_jax_variables)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def names(units):
    return [(u.name, u.kind) for u in units]


def _both(fn_name, units, *args):
    """JAX's and the port's helper on copies of the same units: their
    outputs, or the exceptions they raise."""
    out = []
    for mod, cls in ((jt, jt.TorchUnit), (pt, pt.TorchUnit)):
        copy = [cls(u.name, u.kind, {}) for u in units]
        fn = getattr(mod, fn_name) if isinstance(fn_name, str) \
            else fn_name(mod)
        try:
            out.append(names(fn(copy, *args)))
        except Exception as e:                    # noqa: BLE001
            out.append(type(e).__name__)
    return out


U = lambda n, k='conv': pt.TorchUnit(n, k, {})   # noqa: E731

HELPER_CASES = [
    ('order_children', [U('d1.0'), U('d1.1'), U('ref.0'), U('m.0')],
     ('', ['ref', 'd1', 'm'])),
    ('order_children', [U('pre.0'), U('s.b.0'), U('s.a.0'), U('s.a.1'),
                        U('post.0')], ('s', ['a', 'b'])),
    ('order_children', [U('s.z.0'), U('s.y.0'), U('s.a.0')], ('s', ['a'])),
    ('order_siblings', [U('b1.conv.0'), U('b1.pool.0'), U('x.0'),
                        U('b2.conv.0'), U('b2.pool.0')], (['pool', 'conv'],)),
    ('order_siblings', [U('b.conv.0'), U('b.act.0', 'prelu'), U('b.pool.0')],
     (['pool', 'conv'],)),
    ('order_siblings', [U('m.conv.0'), U('m.bn', 'bn'), U('m.conv.1')],
     (['pool', 'conv'],)),
    ('swap_sibling_runs', [U('g.right_branch.0'), U('g.right_branch.1'),
                           U('g.left_branch.0'), U('tail.0')],
     ('left_branch', 'right_branch')),
]


@pytest.mark.parametrize('i', range(len(HELPER_CASES)))
def test_helpers_equal_jax_on_the_unit_tests_lists(i):
    fn, units, args = HELPER_CASES[i]
    jax_out, port_out = _both(fn, units, *args)
    assert jax_out == port_out


def test_sd_leaf_units_equal_jax():
    sd = {
        'a.conv.weight': np.zeros((4, 3, 3, 3)),
        'a.bn.weight': np.zeros(4), 'a.bn.bias': np.zeros(4),
        'a.bn.running_mean': np.zeros(4), 'a.bn.running_var': np.zeros(4),
        'a.bn.num_batches_tracked': np.zeros(()),
        'head.weight': np.zeros((10, 4)), 'head.bias': np.zeros(10),
        'act.weight': np.zeros(1),
        'ln.weight': np.zeros(8), 'ln.bias': np.zeros(8),
    }
    assert names(pt.sd_leaf_units(sd)) == names(jt.sd_leaf_units(sd))
    with pytest.raises(NotImplementedError):
        pt.sd_leaf_units({'x.weight': np.zeros((2, 2, 2))})


def _fixup_vocabulary(key):
    """(the dotted scope names a fixup's source mentions, their parts)."""
    fn = jt.SD_REORDER[key]
    src = inspect.getsource(fn)
    for called in re.findall(r'(_fix_\w+)\(', src):
        src += inspect.getsource(getattr(jt, called))
    src = src.replace("f'decoder.{g}'", "'decoder.gau1'")
    literals = sorted(set(re.findall(r"'([A-Za-z_][\w.]*)'", src)))
    words = sorted({w for lit in literals for w in lit.split('.')})
    return literals, words + ['0', '1', 'conv', 'bn']


def _random_name(rng, literals, words):
    """A scope path: a mentioned scope (parent or child) or loose words,
    with children and a leaf below."""
    parts = [rng.choice(literals)] if rng.random() < 0.7 else []
    parts += [rng.choice(words) for _ in range(rng.randint(0, 2))]
    return '.'.join(parts + [rng.choice(['0', 'conv', 'bn'])])


@pytest.mark.parametrize('key', sorted(jt.SD_REORDER))
def test_fixup_equals_jax(key):
    assert sorted(pt.SD_REORDER) == sorted(jt.SD_REORDER)
    literals, words = _fixup_vocabulary(key)
    rng = random.Random(key)
    for _ in range(60):
        units = [U(_random_name(rng, literals, words),
                   rng.choice(['conv', 'bn', 'conv4d']))
                 for _ in range(rng.randint(4, 24))]
        # the reference's parents hold their children contiguously, in
        # either order
        units.sort(key=lambda u: u.name.split('.')[:-1],
                   reverse=rng.random() < 0.5)
        jax_out, port_out = _both(lambda mod: mod.SD_REORDER[key], units)
        assert jax_out == port_out


# ----------------------------------------------------------- Flax leaf order

MODELS = {
    'fastscnn': dict(model='fastscnn'),
    'bisenetv2': dict(model='bisenetv2', use_aux=True),
    'ddrnet': dict(model='ddrnet', use_aux=True),
    'icnet': dict(model='icnet', use_aux=True),
    'stdc': dict(model='stdc', use_detail_head=True),
    'smp_unetpp': dict(model='smp', encoder='resnet18', decoder='unetpp'),
    'smp_manet': dict(model='smp', encoder='resnet18', decoder='manet'),
    'smp_pan': dict(model='smp', encoder='resnet18', decoder='pan'),
}
for _key in jt.SD_REORDER:
    MODELS.setdefault(_key, dict(model=_key))


@functools.lru_cache(maxsize=None)
def _jax_units(key, side):
    """JAX's flax_leaf_order of MODELS[key] (5 classes) on a
    (1, side, side, 3) input, traced under jax.eval_shape once."""
    jax_model = jax_get_model(JaxSegConfig(num_class=5, **MODELS[key]))
    box = {}

    def init(xx):
        variables, units = jt.flax_leaf_order(jax_model, xx, True)
        box['units'] = units
        return variables

    jax.eval_shape(init, jax.ShapeDtypeStruct((1, side, side, 3),
                                              jnp.float32))
    return tuple(box['units'])


@pytest.mark.parametrize('key', sorted(MODELS))
def test_flax_leaf_order_equals_jax(key):
    kw = MODELS[key]
    side = 128 if kw['model'] == 'smp' else 64
    x = np.random.default_rng(0).uniform(-1, 1, (1, side, side, 3)
                                         ).astype(np.float32)
    want = _jax_units(key, side)
    model = get_model(SegConfig(num_class=5, **kw), device='cpu')
    variables, got = pt.flax_leaf_order(model, x)
    assert [(u.path, u.kind) for u in got] == \
        [(tuple(u.path), u.kind) for u in want]
    leaves = {p[1:-1] for p in dict(_flatten(variables))}
    assert {u.path for u in got} == leaves


# -------------------------------------------------------- the tree and .pth

def _seeded(key, seed=3):
    model = get_model(SegConfig(num_class=19, **MODELS[key]), device='cpu')
    load_jax_variables(model, random_jax_variables(model, seed))
    return model.eval()


def _call_order_state_dict(model, x):
    sd = {}
    for unit in pt.torch_leaf_order(model, lambda m: m(x)):
        for leaf, value in unit.arrays.items():
            sd[f'{unit.name}.{leaf}'] = value
    return sd


def test_apply_units_gives_jaxs_tree():
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 3)
                                         ).astype(np.float32)
    src = _seeded('fastscnn')
    sd = _call_order_state_dict(src, torch.from_numpy(x))
    dst = get_model(SegConfig(num_class=19, model='fastscnn'), device='cpu')
    got = pt.import_reference_state_dict(sd, 'fastscnn', dst, x)
    start, _ = pt.flax_leaf_order(dst, x)
    want = jt.apply_units(start, list(_jax_units('fastscnn', 64)),
                          jt.sd_leaf_units(sd))
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], '/'.join(k))


def test_transplant_from_module_copies_a_model():
    """Call order on both sides: a seeded port model's tensors into a
    fresh one through transplant_from_module give the same logits."""
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3)
                                         ).astype(np.float32)
    src = _seeded('fastscnn', seed=6)
    dst = get_model(SegConfig(num_class=19, model='fastscnn'), device='cpu')
    variables, flax_units, torch_units = pt.transplant_from_module(
        src, dst, x, torch_forward=lambda m: m(torch.from_numpy(x)))
    assert [u.path for u in flax_units] == \
        [tuple(u.name.split('.')) for u in torch_units]
    load_jax_variables(dst, variables)
    with torch.no_grad():
        assert torch.equal(dst.eval()(torch.from_numpy(x)),
                           src(torch.from_numpy(x)))


def test_import_tool_gives_jaxs_logits(tmp_path):
    """A reference-style {'state_dict': ...} .pth of a seeded FastSCNN
    (no SD_REORDER entry: registration order is call order) through the
    tool; the imported port model against the JAX model with JAX's
    import of the same file, and against the source model."""
    import importlib.util
    x = np.random.default_rng(2).uniform(-1.5, 1.5, (2, 64, 128, 3)
                                         ).astype(np.float32)
    src = _seeded('fastscnn', seed=9)
    sd = _call_order_state_dict(src, torch.from_numpy(x[:1]))
    pth = tmp_path / 'best.pth'
    torch.save({'state_dict': {k: torch.from_numpy(v)
                               for k, v in sd.items()}, 'cur_epoch': 3}, pth)
    spec = importlib.util.spec_from_file_location(
        'torch_import_reference', ROOT / 'tools' / 'torch_import_reference.py')
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / 'imported.ckpt'
    assert tool.main(['--model', 'fastscnn', '--num_class', '19', '--pth',
                      str(pth), '--out', str(out)]) == 0
    meta = load_meta(str(out))
    assert meta['kind'] == 'best' and meta['imported_from'] == str(pth)
    model = get_model(SegConfig(num_class=19, model='fastscnn'),
                      device='cpu').eval()
    restore_weights(str(out), model)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        ref = src(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)

    jax_model = jax_get_model(JaxSegConfig(num_class=19, model='fastscnn'))
    start, _ = pt.flax_leaf_order(model, x[:1])
    variables = jt.apply_units(start, list(_jax_units('fastscnn', 64)),
                               jt.sd_leaf_units(sd))
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, xx: jax_model.apply(v, xx, False))(
            variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_import_tool_trace_sides():
    tool_path = ROOT / 'tools' / 'torch_import_reference.py'
    sys.path.insert(0, str(tool_path.parent))
    try:
        import torch_import_reference as tool
    finally:
        sys.path.remove(str(tool_path.parent))

    class A:
        imgh = imgw = 64
        model, encoder = 'smp', 'resnet18'
    assert tool.trace_side(A) == (128, 128)
    A.encoder = 'mit_b0'
    assert tool.trace_side(A) == (256, 256)
    A.model = 'fastscnn'
    assert tool.trace_side(A) == (64, 64)
