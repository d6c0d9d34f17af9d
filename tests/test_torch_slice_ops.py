"""PyTorch port against the JAX package: the ops of the BiSeNetv2 eval
slice, the plain versions of its two kernels, the weight converter, and the
port's import boundary.

Inputs are made with numpy from fixed seeds and go through both packages.
The JAX kernels run as their own tests run them on the CPU (Pallas in
interpret mode); the port runs on CPU tensors, so its kernel wrappers take
their plain versions.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.ops import pool as jpool
from rtseg_tpu.ops import resize as jresize
from rtseg_tpu.ops.fused_head import fused_path as j_fused_path
from rtseg_tpu.ops.fused_head import resize_argmax as j_resize_argmax
from rtseg_tpu.ops.pallas_metrics import confusion_matrix_pallas as j_cm

from rtseg_tpu_torch.ops import pool as tpool
from rtseg_tpu_torch.ops import resize as tresize
from rtseg_tpu_torch.ops.fused_head import (_argmax_ref, interp_taps,
                                            resize_argmax)
from rtseg_tpu_torch.ops.pallas_metrics import confusion_matrix_pallas
from rtseg_tpu_torch.utils.metrics import (confusion_matrix, iou_from_cm,
                                           miou_from_cm)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize('align_corners', [True, False])
@pytest.mark.parametrize('sizes', [(8, 64), (128, 1024), (13, 5), (1, 7),
                                   (7, 1)])
def test_interp_matrix_matches_jax(sizes, align_corners):
    np.testing.assert_array_equal(
        tresize._interp_matrix(*sizes, align_corners),
        jresize._interp_matrix(*sizes, align_corners))


@pytest.mark.parametrize('size,align_corners', [((13, 21), True),
                                                ((4, 5), True),
                                                ((20, 18), False)])
def test_resize_bilinear_matches_jax(size, align_corners):
    x = np.random.RandomState(0).randn(2, 7, 9, 5).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), size,
                                              align_corners))
    got = tresize.resize_bilinear(_t(x), size, align_corners).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_final_upsample_defer_and_refusal():
    x = torch.ones(1, 4, 8, 8)
    assert tresize.final_upsample(x, (32, 32), defer=True).shape == x.shape
    assert tresize.final_upsample(x, (32, 32)).shape == (1, 4, 32, 32)
    with pytest.raises(ValueError, match='cannot be deferred'):
        tresize.final_upsample(x, (32, 32), align_corners=False, defer=True)


# ------------------------------------------------------------------- pools

def _pool_input(seed):
    # multiples of 1/8 in [-4, 4): window sums and means are exact in f32,
    # so any difference is a difference of semantics, not of summation order
    return (np.random.RandomState(seed).randint(-32, 32, (2, 9, 11, 6))
            / 8.0).astype(np.float32)


def test_max_pool_matches_jax():
    x = np.random.RandomState(1).randn(2, 9, 11, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tpool.max_pool(_t(x), 3, 2, 1).numpy(),
        np.asarray(jpool.max_pool(jnp.asarray(x), 3, 2, 1)))


def test_avg_pool_matches_jax():
    x = _pool_input(2)
    np.testing.assert_array_equal(
        tpool.avg_pool(_t(x), 3, 2, 1).numpy(),
        np.asarray(jpool.avg_pool(jnp.asarray(x), 3, 2, 1)))


def test_global_avg_pool_matches_jax():
    x = _pool_input(3)[:, :8, :8]
    np.testing.assert_array_equal(
        tpool.global_avg_pool(_t(x)).numpy(),
        np.asarray(jpool.global_avg_pool(jnp.asarray(x))))


# ----------------------------------------------- K1: fused upsample + argmax

def _mismatch(a, b):
    return float((np.asarray(a) != np.asarray(b)).mean())


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-4),
                                       ('bfloat16', 8e-3)])
def test_resize_argmax_plain_matches_jax_kernel(dtype, tol):
    x = np.random.RandomState(1).randn(2, 32, 64, 19).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    assert j_fused_path(xj.shape, (256, 512), xj.dtype) == 'pallas'
    want = j_resize_argmax(xj, (256, 512))
    got = resize_argmax(_t(x).to(getattr(torch, dtype)), (256, 512))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 256, 512)
    assert _mismatch(got.numpy(), want) <= tol


def test_resize_argmax_integer_logits_match_jax():
    x = (np.random.RandomState(0).randint(-8, 8, (2, 16, 32, 7))
         .astype(np.float32) * 4.0)
    want = j_resize_argmax(jnp.asarray(x), (128, 256))
    assert _mismatch(resize_argmax(_t(x), (128, 256)).numpy(), want) <= 1e-4


def test_resize_argmax_ties_and_identity_match_jax():
    zeros = np.zeros((1, 8, 8, 5), np.float32)
    assert (resize_argmax(_t(zeros), (64, 128)).numpy() == 0).all()
    assert (np.asarray(j_resize_argmax(jnp.asarray(zeros), (64, 128)))
            == 0).all()
    x = np.random.RandomState(2).randn(1, 16, 16, 5).astype(np.float32)
    np.testing.assert_array_equal(
        resize_argmax(_t(x), (16, 16)).numpy(),
        np.asarray(j_resize_argmax(jnp.asarray(x), (16, 16))))


def test_resize_argmax_untileable_matches_jax_fallback():
    # a shape the TPU kernel cannot tile: JAX materializes, the port's
    # kernel takes every shape
    x = np.random.RandomState(3).randn(1, 10, 13, 6).astype(np.float32)
    assert j_fused_path(x.shape, (37, 53)) == 'materialize'
    np.testing.assert_array_equal(
        resize_argmax(_t(x), (37, 53)).numpy(),
        np.asarray(j_resize_argmax(jnp.asarray(x), (37, 53))))


def test_resize_argmax_routes_cpu_to_plain_and_refuses_other_devices():
    x = torch.from_numpy(
        np.random.RandomState(4).randn(2, 8, 16, 19).astype(np.float32))
    before = resize_argmax.launches
    assert torch.equal(resize_argmax(x, (64, 128)), _argmax_ref(x, (64, 128)))
    assert resize_argmax.launches == before          # plain: no launch
    with pytest.raises(ValueError, match='unsupported device'):
        resize_argmax(torch.empty(2, 8, 16, 19, device='meta'), (64, 128))


@pytest.mark.parametrize('align_corners', [True, False])
@pytest.mark.parametrize('sizes', [(128, 1024), (8, 64), (10, 37), (3, 3),
                                   (5, 2)])
def test_interp_taps_rebuild_the_dense_operator(sizes, align_corners):
    # the kernel's two taps per row must be the dense H-interpolation
    # operator of the TPU kernel, exactly
    lo, hi, wlo, whi = interp_taps(*sizes, align_corners)
    m = tresize._interp_matrix(*sizes, align_corners)
    dense = np.zeros_like(m)
    rows = np.arange(m.shape[0])
    np.add.at(dense, (rows, lo), wlo)
    np.add.at(dense, (rows, hi), whi)
    np.testing.assert_array_equal(dense, m)
    assert lo.dtype == hi.dtype == np.int32
    assert wlo.dtype == whi.dtype == np.float32


# ------------------------------------------------------ K2: confusion matrix

def _cm_inputs(seed, C, shape=(2, 64, 128)):
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, C + 3, shape).astype(np.int32)      # some >= C
    labels = rng.randint(-1, C + 3, shape).astype(np.int32)    # -1, >= C
    labels[rng.rand(*shape) < 0.1] = 255                       # ignored
    return preds, labels


STREET_SHARES = (0.37, 0.23, 0.16, 0.07, 0.06, 0.04)


def _other_class(rng, cls, C):
    return (cls + rng.randint(1, C, cls.shape)) % C


def _cm_family(family, C=19, seed=0, shape=(2, 64, 128)):
    """(preds, labels) of one input family of the confusion-matrix kernel,
    at a small size: 'uniform' random with ignored and out-of-range values;
    'synthetic' 8x8 cells (data/synthetic.py) with predictions right on 90%
    of the cells; 'street' a class field at 1/32 resolution with a
    street-scene skew (shares STREET_SHARES, the rest even over the other
    classes), about 10% ignored (a bottom band and random cells) and
    predictions right on 90% of the cells; 'one_key' one (label,
    prediction) everywhere."""
    rng = np.random.RandomState(seed)
    b, h, w = shape
    if family == 'uniform':
        return _cm_inputs(seed, C, shape)
    if family == 'one_key':
        return np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    cell = 8 if family == 'synthetic' else 32
    field = (b, h // cell, w // cell)
    if family == 'synthetic':
        lab = rng.randint(0, C, field)
    else:
        rest = (1 - sum(STREET_SHARES)) / (C - len(STREET_SHARES))
        shares = list(STREET_SHARES) + [rest] * (C - len(STREET_SHARES))
        lab = rng.choice(C, field, p=np.asarray(shares) / sum(shares))
    pred = np.where(rng.rand(*field) < 0.1, _other_class(rng, lab, C), lab)
    if family == 'street':
        lab = np.where(rng.rand(*field) < 0.05, 255, lab)
        lab[:, -max(1, field[1] // 16):] = 255       # the bottom band
    up = lambda a: a.repeat(cell, 1).repeat(cell, 2).astype(np.int32)
    return up(pred), up(lab)


# the four input families, and uniform maps of odd length and as views
# that start 1 and 3 elements into their storage
CM_CASES = ('uniform', 'synthetic', 'street', 'one_key', 'odd', 'offset')


@pytest.mark.parametrize('case', CM_CASES)
@pytest.mark.parametrize('label_dtype', [np.int32, np.int64])
def test_confusion_matrix_plain_bit_equal_to_jax_kernel(label_dtype, case):
    C = 19
    shape = (2, 128, 256) if case == 'street' else (2, 64, 128)
    preds, labels = _cm_family(case if case in CM_CASES[:4] else 'uniform',
                               C, shape=shape)
    preds, labels = preds.reshape(-1), labels.astype(label_dtype).reshape(-1)
    if case == 'odd':
        preds, labels = preds[:-7], labels[:-7]
    want = np.asarray(j_cm(jnp.asarray(preds), jnp.asarray(labels), C, 255))
    tp, tl = _t(preds), _t(labels)
    if case == 'offset':
        n = tp.numel()
        tp = torch.cat([tp[:3], tp])[3:]
        tl = torch.cat([tl[:1], tl])[1:]
        assert (tp.storage_offset(), tl.storage_offset()) == (3, 1)
        assert tp.is_contiguous() and tl.is_contiguous() and tp.numel() == n
    for fn in (confusion_matrix, confusion_matrix_pallas):
        got = fn(tp, tl, C, 255)
        assert got.dtype == torch.int32 and tuple(got.shape) == (C, C)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_confusion_matrix_rejects_non_integer_types_on_cuda_path():
    # type checks belong to the kernel path; on the CPU the plain version
    # casts like the JAX package does
    preds, labels = _cm_inputs(1, 5, (1, 4, 4))
    got = confusion_matrix_pallas(_t(preds).long(), _t(labels), 5, 255)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_cm(jnp.asarray(preds),
                                     jnp.asarray(labels), 5, 255)))
    with pytest.raises(ValueError, match='CUDA device'):
        confusion_matrix_pallas(torch.empty(4, dtype=torch.int32,
                                            device='meta'),
                                _t(labels).reshape(-1)[:4], 5)


def test_iou_matches_jax_package():
    from rtseg_tpu.utils.metrics import iou_from_cm as j_iou
    from rtseg_tpu.utils.metrics import miou_from_cm as j_miou
    cm = np.random.RandomState(5).randint(0, 1000, (19, 19))
    cm[3] = 0
    cm[:, 3] = 0                                   # an absent class
    np.testing.assert_array_equal(iou_from_cm(cm), j_iou(cm))
    assert miou_from_cm(cm) == j_miou(cm)


# ------------------------------------------------------------ weight converter

@pytest.fixture(scope='module')
def bisenet_pair():
    from rtseg_tpu.models.bisenetv2 import BiSeNetv2 as JaxBiSeNetv2
    from rtseg_tpu_torch.models.bisenetv2 import BiSeNetv2
    jm = JaxBiSeNetv2(num_class=19, use_aux=True)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)))
    return shapes, BiSeNetv2(19, use_aux=True).eval()


def _flat(tree):
    from rtseg_tpu_torch.utils.convert import _flatten
    return _flatten(tree)


def test_converter_covers_every_flax_leaf(bisenet_pair):
    from rtseg_tpu_torch.utils.convert import to_jax_variables
    shapes, model = bisenet_pair
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    flax_leaves = {path: v.shape for path, v in _flat(zeros).items()}
    port_leaves = {path: v.shape
                   for path, v in _flat(to_jax_variables(model)).items()}
    assert port_leaves == flax_leaves
    assert any(p[1] == 'SemanticBranch_0' and p[2] == 'seg_head5'
               for p in port_leaves)


def test_converter_round_trip_and_strictness(bisenet_pair):
    from rtseg_tpu_torch.models.bisenetv2 import BiSeNetv2
    from rtseg_tpu_torch.utils.convert import (from_jax_variables,
                                               load_jax_variables,
                                               random_jax_variables,
                                               to_jax_variables)
    _, model = bisenet_pair
    variables = random_jax_variables(model, seed=0)
    fresh = BiSeNetv2(19, use_aux=True).eval()
    load_jax_variables(fresh, variables)
    back = _flat(to_jax_variables(fresh))
    want = _flat(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    # a kernel lands transposed HWIO -> OIHW
    k = ('params', 'SegHead_0', 'ConvBNAct_0', 'Conv_0', 'conv', 'kernel')
    sd = from_jax_variables(variables, fresh)
    w = sd['SegHead_0.ConvBNAct_0.Conv_0.conv.weight'].numpy()
    np.testing.assert_array_equal(w, want[k].transpose(3, 2, 0, 1))

    missing = random_jax_variables(model, seed=0)
    del missing['batch_stats']['SegHead_0']['ConvBNAct_0']['BatchNorm_0']
    with pytest.raises(KeyError, match='without a Flax leaf'):
        load_jax_variables(fresh, missing)
    extra = random_jax_variables(model, seed=0)
    extra['params']['SegHead_0']['Conv_0']['conv']['scale'] = np.ones(19)
    with pytest.raises(KeyError, match='unmapped Flax leaf'):
        load_jax_variables(fresh, extra)
    wrong = random_jax_variables(model, seed=0)
    wrong['params']['SegHead_0']['Conv_0']['conv']['kernel'] = \
        np.zeros((1, 1, 128, 7), np.float32)
    with pytest.raises(ValueError, match='shape'):
        load_jax_variables(fresh, wrong)


# ------------------------------------------------------------ import boundary

def _port_sources():
    files = sorted((ROOT / 'rtseg_tpu_torch').rglob('*.py'))
    return files + sorted((ROOT / 'tools').glob('torch_*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'main_torch.py']


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Nor the libraries the machines with a card lack: the port decodes
    PNGs, resizes and reads data.yaml itself."""
    banned = {'jax', 'jaxlib', 'flax', 'orbax', 'optax', 'rtseg_tpu',
              'cv2', 'PIL', 'yaml'}
    files = _port_sources()
    assert len(files) > 15
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            offenders += [f'{path.relative_to(ROOT)}:{node.lineno} {n}'
                          for n in names if n.split('.')[0] in banned]
    assert not offenders, offenders


# ------------------------------------------------------------- kernel build

def _fake_nvcc(tmp_path, exit_code=0):
    """A stand-in compiler: writes the '-o' file, or fails loudly."""
    script = tmp_path / f'nvcc_{exit_code}'
    script.write_text(
        '#!/usr/bin/env python3\n'
        'import sys\n'
        f'if {exit_code}:\n'
        '    print("error: no kernel for you"); sys.exit(1)\n'
        'open(sys.argv[sys.argv.index("-o") + 1], "w").write("so")\n')
    script.chmod(0o755)
    return str(script)


def test_kernel_build_is_atomic_incremental_and_loud(tmp_path, monkeypatch):
    from rtseg_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, '_BUILD', tmp_path / '_build')
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: _fake_nvcc(tmp_path))
    assert set(cuda_build.build()) == set(cuda_build.KERNELS)
    for name in cuda_build.KERNELS:
        assert cuda_build.library_path(name).read_text() == 'so'
    assert cuda_build.build() == {}                  # nothing stale
    assert set(cuda_build.build(force=True)) == set(cuda_build.KERNELS)

    monkeypatch.setattr(cuda_build, '_nvcc',
                        lambda: _fake_nvcc(tmp_path, exit_code=1))
    with pytest.raises(RuntimeError, match='no kernel for you'):
        cuda_build.build(['fused_head'], force=True)
    # the failed build left the previous library and no temporary file
    assert sorted(p.name for p in (tmp_path / '_build').iterdir()) == \
        sorted(f'lib{n}.so' for n in cuda_build.KERNELS)
    with pytest.raises(RuntimeError, match='CUDA error 2'):
        cuda_build.check(2, 'fused_head')
