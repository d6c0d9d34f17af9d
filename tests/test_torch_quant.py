"""The port's int8 post-training quantization (rtseg_tpu_torch/quant/,
tools/torch_segquant.py) against the JAX package's (rtseg_tpu/quant/), on
the CPU.

Bit for bit: quantize_params, dequantize_params and corrupt_scales on
JAX's test trees, and the quantized leaves and scale fingerprint of
FastSCNN's and BiSeNetv2's Flax init trees; select_calibration_indices,
calibration_hash and _np_miou. The JAX test's `calibrated` fixture
(FastSCNN at 64x64, 2 synthetic samples, the PRNGKey(0) init) run through
both packages: the record's `weights` and `calib` sections byte-equal,
`agreement_frac` and the mIoU within 1e-3, the port's two runs
byte-identical; the activation-scale keys equal to Flax's intermediates
(values within 1e-4). A transposed conv (ENet) quantized on the JAX
package's axis and moved into the torch layout. The quant boundary: the
exported int8 program's int8 -> float conversions number the quantized
leaves (plus 1 with an input scale), each made in rtseg_tpu_torch/quant/,
and one made elsewhere is caught. The CLI's table and exit codes."""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu import quant as jq
from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.models import get_model as jax_get_model
from rtseg_tpu_torch import quant as pq
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models.registry import get_model
from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                           load_jax_variables,
                                           to_jax_variables)

# the modules (each package's `calibrate` attribute is the function)
jax_calibrate_mod = importlib.import_module('rtseg_tpu.quant.calibrate')
port_calibrate_mod = importlib.import_module('rtseg_tpu_torch.quant.calibrate')

ROOT = Path(__file__).resolve().parents[1]
QUANT_DIR = str(ROOT / 'rtseg_tpu_torch' / 'quant') + '/'


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(model='fastscnn', **kw):
    c = SegConfig(dataset='synthetic', model=model, num_class=19,
                  compute_dtype='float32', use_tb=False, **kw)
    c.resolve(num_devices=1)
    return c


def _leaves(tree, path=()):
    """(path, leaf) over nested dicts, a qleaf dict being a leaf."""
    if isinstance(tree, dict) and tree.get('kind') != pq.QKIND:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_same_qtree(ours, theirs):
    a, b = list(_leaves(ours)), list(_leaves(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert pq.is_qleaf(x) == jq.is_qleaf(y), path
        if pq.is_qleaf(x):
            for k in ('q', 'scale'):
                got, want = np.asarray(x[k]), np.asarray(y[k])
                assert got.dtype == want.dtype and got.shape == want.shape
                assert np.array_equal(got, want), (path, k)
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), path


# ------------------------------------------------- JAX's test trees, bit-equal
def _roundtrip_tree():
    rng = np.random.default_rng(0)
    return {'conv': {'kernel': (rng.standard_normal((3, 3, 4, 8))
                                * rng.uniform(0.01, 10, 8)).astype(np.float32),
                     'bias': rng.standard_normal(8).astype(np.float32)},
            'dense': {'kernel':
                      rng.standard_normal((16, 5)).astype(np.float32)}}


def _zero_channel_tree():
    k = np.zeros((2, 2, 3, 4), np.float32)
    k[..., 0] = 1.0
    return {'k': k}


def key_in(tree, key):
    return key[0] in tree and key[1] in tree[key[0]]


@pytest.mark.parametrize('make', [_roundtrip_tree, _zero_channel_tree])
def test_quantize_and_dequantize_equal_jax(make):
    params = make()
    ours, theirs = pq.quantize_params(params), jq.quantize_params(params)
    _assert_same_qtree(ours, theirs)
    deq, jdeq = pq.dequantize_params(ours), jq.dequantize_params(theirs)
    for (path, x), (_, y) in zip(_leaves(deq), _leaves(jdeq)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path
    assert pq.scale_fingerprint(ours) == jq.scale_fingerprint(theirs)
    assert pq.quantized_nbytes(ours) == jq.quantized_nbytes(theirs)
    # the symmetric grid's half-step guarantee, as the JAX test holds it
    for key in [k for k in (('conv', 'kernel'), ('dense', 'kernel'))
                if key_in(params, k)]:
        orig = params[key[0]][key[1]]
        scale = ours[key[0]][key[1]]['scale']
        err = np.abs(orig - deq[key[0]][key[1]]).reshape(
            -1, orig.shape[-1]).max(0)
        assert (err <= scale / 2 + 1e-7).all()


@pytest.mark.parametrize('amount,seed', [(0.5, 7), (0.5, 8), (0.0, 7),
                                         (0.2, 3)])
def test_corrupt_scales_equal_jax(amount, seed):
    rng = np.random.default_rng(1)
    variables = {'params': dict(_roundtrip_tree(), extra={
        'kernel': rng.standard_normal((3, 3, 2, 4)).astype(np.float32)})}
    ours = pq.corrupt_scales(pq.quantize_variables(variables), amount, seed)
    theirs = jq.corrupt_scales(jq.quantize_variables(variables), amount,
                               seed)
    _assert_same_qtree(ours['params'], theirs['params'])
    assert pq.scale_fingerprint(ours['params']) == \
        jq.scale_fingerprint(theirs['params'])


@pytest.mark.parametrize('model', ['fastscnn', 'bisenetv2'])
def test_flax_init_trees_quantize_as_jax(model, calibrated):
    """The quantized leaves, the byte accounting and the scale fingerprint
    of the model's Flax init tree: FastSCNN's from Flax's own model.init
    (the calibration fixture's, PRNGKey(0)), BiSeNetv2's from
    utils/convert.py's Flax initializers."""
    if model == 'fastscnn':
        variables, theirs = calibrated[3][1], calibrated[4]['params']
    else:
        variables = flax_init_variables(get_model(_cfg(model)), 0)
        theirs = jq.quantize_variables(variables)['params']
    ours = pq.quantize_variables(variables)['params']
    _assert_same_qtree(ours, theirs)
    assert pq.scale_fingerprint(ours) == jq.scale_fingerprint(theirs)
    assert pq.quantized_nbytes(ours) == jq.quantized_nbytes(theirs)


def test_calibration_helpers_equal_jax():
    for n, k, seed in ((100, 8, 3), (100, 8, 4), (5, 99, 0), (2975, 16, 1)):
        assert pq.select_calibration_indices(n, k, seed) == \
            jq.select_calibration_indices(n, k, seed)
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    masks = rng.integers(0, 19, (3, 8, 8)).astype(np.uint8)
    for m, idx in ((None, None), (masks, [1, 4, 9])):
        assert port_calibrate_mod.calibration_hash(images, m, 5, idx) == \
            jax_calibrate_mod.calibration_hash(images, m, 5, idx)
    pred = rng.integers(0, 19, (2, 16, 16)).astype(np.int8)
    ref = rng.integers(0, 21, (2, 16, 16)).astype(np.int64)
    assert port_calibrate_mod._np_miou(pred, ref, 19) == \
        jax_calibrate_mod._np_miou(pred, ref, 19)


# --------------------------------------------------- the transposed-conv axis
def test_a_transposed_conv_is_quantized_on_the_jax_axis():
    """ENet's ConvTranspose2d weights: each kernel's q and scale are JAX's
    quantize_params of it, the int8 buffers are that q moved by the
    converter's rule, each scale along the torch axis the Flax kernel's
    last axis goes to, and the forward's dequantized weights are JAX's
    dequant in the torch layout; every dequantized weight is the host
    dequant's, and the int8 forward's logits are bit-equal to the float
    forward of a model loaded with that host dequant."""
    model = get_model(_cfg('enet')).eval()
    variables = flax_init_variables(model, 0)
    load_jax_variables(model, variables)
    qv = pq.quantize_variables(variables)
    fn = pq.build_quantized_inference_fn(model, qv, 'float32', argmax=False)
    want_model = get_model(_cfg('enet')).eval()
    load_jax_variables(want_model, dict(
        qv, params=pq.dequantize_params(qv['params'])))
    want = dict(want_model.named_parameters())
    weights = fn.weights()
    deconvs = [name for name, m in fn.net.named_modules()
               if isinstance(m, torch.nn.ConvTranspose2d)]
    assert deconvs
    for name in deconvs:
        m = fn.net.get_submodule(name)
        flax, kernel = qv['params'], variables['params']
        for part in name.split('.'):
            flax, kernel = flax[part], kernel[part]
        theirs = jq.quantize_params({'k': kernel['kernel']})
        _assert_same_qtree({'k': flax['kernel']}, theirs)
        q, scale = flax['kernel']['q'], flax['kernel']['scale']
        jdeq = np.asarray(jq.dequantize_params(theirs)['k'])
        assert torch.equal(weights[f'{name}.weight'], torch.from_numpy(
            jdeq.transpose(3, 2, 0, 1)))
        assert np.array_equal(m.weight_q.numpy(), q.transpose(3, 2, 0, 1))
        assert m.weight_q.dtype == torch.int8
        assert tuple(m.weight_scale.shape) == (q.shape[-1], 1, 1, 1)
        assert 'weight' not in dict(m.named_parameters())
    for name, w in weights.items():
        assert torch.equal(w, want[name].detach()), name
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    from rtseg_tpu_torch.export import build_inference_fn
    assert torch.equal(fn(x), build_inference_fn(want_model, 'float32',
                                                 argmax=False)(x))
    # the model it was built from is unchanged
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaves(to_jax_variables(model)), _leaves(variables)))


# ------------------------------------------------- calibration against JAX
@pytest.fixture(scope='module')
def calibrated():
    """tests/test_segquant.py's fixture through both packages: FastSCNN @
    64x64, the PRNGKey(0) init, 2 synthetic samples; the port twice."""
    jcfg = JaxSegConfig(dataset='synthetic', model='fastscnn', num_class=19,
                        compute_dtype='float32',
                        save_dir='/tmp/rtseg_segquant_test', use_tb=False)
    jcfg.resolve(num_devices=1)
    net = jax_get_model(jcfg)
    # jitted, the same values as the eager init in a quarter of the time
    variables = jax.device_get(jax.jit(lambda key: net.init(
        key, jnp.zeros((1, 64, 64, 3), jnp.float32), False))(
            jax.random.PRNGKey(0)))
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)
    kw = dict(compute_dtype='float32', num_class=19, max_drop=0.5,
              source='synthetic', seed=0)
    jqv = jq.quantize_variables(variables)
    theirs = jq.calibrate(net, variables, jqv, images, None, **kw)
    model = get_model(_cfg()).eval()
    qv = pq.quantize_variables(variables)
    r1 = pq.calibrate(model, variables, qv, images, None, **kw)
    r2 = pq.calibrate(model, variables, qv, images, None, **kw)
    return theirs, r1, r2, (net, variables, model, images), jqv


def test_calibration_record_equals_jax(calibrated):
    theirs, ours, again = calibrated[:3]
    assert pq.record_to_json(ours) == pq.record_to_json(again)
    for section in ('weights', 'calib', 'precision', 'activations'):
        assert json.dumps(ours[section], sort_keys=True) == \
            json.dumps(theirs[section], sort_keys=True), section
    assert abs(ours['agreement_frac'] - theirs['agreement_frac']) <= 1e-3
    assert ours['miou']['reference'] == theirs['miou']['reference'] \
        == 'f32_forward'
    for k in ('f32', 'int8', 'drop'):
        assert abs(ours['miou'][k] - theirs['miou'][k]) <= 1e-3, k
    assert ours['gate'] == theirs['gate']
    assert set(ours) == set(theirs)


def test_activation_scales_keys_equal_flax(calibrated):
    """Every intermediate Flax's capture_intermediates gives for FastSCNN
    is reproduced under the same key (none is left out), and the scales
    agree within 1e-4."""
    net, variables, model, images = calibrated[3]
    theirs = jax_calibrate_mod.activation_scales(net, variables, images,
                                                 'float32')
    ours = port_calibrate_mod.activation_scales(model, variables, images,
                                                'float32')
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert abs(ours[k] - theirs[k]) <= 1e-4 * theirs[k], k
    record = pq.calibrate(model, variables, pq.quantize_variables(variables),
                          images, None, compute_dtype='float32',
                          activations=True)
    assert record['activations']['tensors'] == len(theirs)
    assert record['activations']['input_scale'] == \
        float(np.max(np.abs(images))) / pq.QMAX


# ----------------------------------------------------------- quant boundary
def _int8_to_float(exported):
    """The exported graph's nodes that turn an int8 tensor into a float
    one, each with the file of the innermost frame of its stack trace
    (the code that made the conversion)."""
    import re
    found = []
    for node in exported.graph.nodes:
        if node.op != 'call_function':
            continue
        val = node.meta.get('val')
        ins = [a.meta.get('val') for a in node.all_input_nodes]
        if isinstance(val, torch.Tensor) and val.dtype.is_floating_point \
                and any(isinstance(v, torch.Tensor) and v.dtype == torch.int8
                        for v in ins):
            files = re.findall(r'File "([^"]+)"',
                               node.meta.get('stack_trace') or '')
            found.append((node, files[-1] if files else None))
    return found


class _Unsanctioned(torch.nn.Module):
    """A quantized forward with one int8 -> float conversion of its own,
    outside rtseg_tpu_torch/quant/."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, images):
        return self.inner(images.to(torch.int8).to(torch.float32))


@pytest.mark.parametrize('input_scale', [None, 1.0 / 127])
def test_quant_boundary_pin(input_scale):
    from rtseg_tpu_torch.export import export_module
    model = get_model(_cfg()).eval()
    variables = flax_init_variables(model, 0)
    qv = pq.quantize_variables(variables)
    n = pq.quantized_nbytes(qv['params'])['quantized_leaves']
    fn = pq.build_quantized_inference_fn(model, qv, 'float32', argmax=True,
                                         input_scale=input_scale)
    exported = export_module(fn, 64, 64, batch=1)
    sites = _int8_to_float(exported)
    assert len(sites) == n + (input_scale is not None)
    for node, where in sites:
        assert where and where.startswith(QUANT_DIR), (node, where)
    # int8 constants, no float copy of a quantized weight
    int8 = [k for k, v in exported.state_dict.items()
            if v.dtype == torch.int8]
    assert len(int8) == n
    if input_scale is None:
        return
    # polarity: a conversion made outside quant/ is caught
    bad = [where for _, where in _int8_to_float(export_module(
        _Unsanctioned(fn), 64, 64, batch=1))
        if not where.startswith(QUANT_DIR)]
    assert bad == [__file__]


# ---------------------------------------------------------------- the CLI
def _fake_record(passed=True):
    return {'precision': 'int8',
            'weights': {'int8': 1 << 20, 'f32': 4 << 20,
                        'quantized_leaves': 4, 'total_leaves': 10,
                        'scale_sha256': '0' * 64},
            'calib': {'source': 'synthetic', 'samples': 2, 'seed': 0,
                      'indices': [], 'hash': '1' * 64},
            'activations': None, 'agreement_frac': 0.97,
            'miou': {'reference': 'f32_forward', 'f32': 1.0,
                     'int8': 0.96, 'drop': 0.04},
            'gate': {'max_drop': 0.05, 'passed': passed}}


def _tool():
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import torch_segquant
    finally:
        sys.path.pop(0)
    return torch_segquant


def test_segquant_cli_table_and_exit(monkeypatch, capsys, tmp_path):
    segquant = _tool()
    monkeypatch.setattr(segquant, 'quantize_one',
                        lambda name, args: _fake_record())
    out_file = tmp_path / 'QUANT.json'
    rc = segquant.main(['--models', 'fastscnn,bisenetv2',
                        '--out', str(out_file)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count('PASS') == 2 and '0.9700' in out
    assert json.loads(out_file.read_text())['precision'] == 'int8'
    monkeypatch.setattr(segquant, 'quantize_one',
                        lambda name, args: _fake_record(passed=False))
    assert segquant.main(['--models', 'fastscnn']) == 1
    assert 'FAIL' in capsys.readouterr().out
    monkeypatch.setattr(segquant, 'quantize_one',
                        lambda name, args: _fake_record())
    assert segquant.main(['--models', 'fastscnn', '--json']) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec['model'] == 'fastscnn' and rec['gate']['passed']
    assert segquant.main(['--models', ',']) == 2
    with pytest.raises(SystemExit) as e:
        segquant.main(['--no-such-flag'])
    assert e.value.code == 2


def test_segquant_cli_runs_on_the_cpu(capsys, tmp_path):
    """A real run on the CPU (named): the record it writes is the
    calibration of the Flax init on the serving preprocess's synthetic
    slice; a model that fails counts as a failure in the table."""
    segquant = _tool()
    out_file = tmp_path / 'QUANT.json'
    rc = segquant.main(['--device', 'cpu', '--models', 'fastscnn',
                        '--imgh', '32', '--imgw', '64', '--samples', '2',
                        '--max-drop', '1.0', '--out', str(out_file)])
    assert rc == 0
    record = json.loads(out_file.read_text())
    assert record['calib']['samples'] == 2 and record['gate']['passed']
    assert record['weights']['quantized_leaves'] == 42
    assert segquant.main(['--device', 'cpu', '--models', 'nosuchnet',
                          '--imgh', '32', '--imgw', '64', '--samples',
                          '1']) == 1
    assert 'FAILED' in capsys.readouterr().out
