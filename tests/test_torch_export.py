"""The port's export plane (rtseg_tpu_torch/export.py over torch.export,
ServeEngine.from_artifact, tools/torch_export.py and torch_segserve.py
--artifact) against the JAX package's (rtseg_tpu/export.py), on the CPU.

FastSCNN at 64x64 on the JAX test's weights (PRNGKey(0) init, moved into
a checkpoint of the port): the int8 argmax artifact at batch 2 against the
JAX package's export_model round trip, the mismatch share under JAX's own
0.005 (tests/test_export.py); the logits artifact with a symbolic batch at
batch 1 and 3 within 1e-5 of JAX's model.apply. BiSeNetv2 and LEDNet (the
models whose interpolation matrices broke an export before the cache
repair of ops/resize.py): a round trip within 1e-5 of the port's eager
forward. The cache repair: eager logits after an export bit-equal to
before, and nothing a trace made left in the cache. from_artifact's batch
rules, its messages and the refusals."""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.export import export_model as jax_export_model
from rtseg_tpu.export import load_exported as jax_load_exported
from rtseg_tpu.export import save_exported as jax_save_exported
from rtseg_tpu.models import get_model as jax_get_model
from rtseg_tpu_torch import export
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.models.registry import get_model
from rtseg_tpu_torch.serve import ServeEngine
from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
from rtseg_tpu_torch.train.state import TrainState
from rtseg_tpu_torch.utils.convert import (flax_init_variables,
                                           load_jax_variables)

ROOT = Path(__file__).resolve().parents[1]
HW = 64


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kw(model='fastscnn', **kw):
    return dict(dataset='synthetic', model=model, num_class=19,
                compute_dtype='float32', use_tb=False, **kw)


def _port_cfg(**kw):
    c = SegConfig(**_kw(**kw))
    c.resolve(num_devices=1)
    return c


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    """JAX's FastSCNN, its PRNGKey(0) variables (export_model's), its
    argmax artifact at batch 2 round-tripped through the file, and a
    checkpoint of the port holding the same variables."""
    cfg = JaxSegConfig(**_kw(save_dir='/tmp/rtseg_export_test'))
    cfg.resolve(num_devices=1)
    model = jax_get_model(cfg)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), False))
    tmp = tmp_path_factory.mktemp('export')
    path = jax_save_exported(
        jax_export_model(cfg, imgh=HW, imgw=HW, batch=2, argmax=True),
        str(tmp / 'fastscnn'))
    port = get_model(_port_cfg())
    load_jax_variables(port, variables)
    ckpt = str(tmp / 'best.ckpt')
    save_best_ckpt(ckpt, TrainState(0, port, None, port), 1, 0.0)
    return model, variables, jax_load_exported(path), ckpt, tmp


def test_argmax_artifact_against_the_jax_round_trip(jax_side):
    _, _, jax_exported, ckpt, tmp = jax_side
    path = export.save_exported(
        export.export_model(_port_cfg(), imgh=HW, imgw=HW, batch=2,
                            argmax=True, ckpt_path=ckpt),
        str(tmp / 'fastscnn'))
    assert path.endswith('.pt2') and export.SUFFIX == '.pt2'
    loaded = export.load_exported(path, 'cpu')
    assert export.artifact_input_shape(loaded) == (2, HW, HW)
    # the weights and the graph, not the example input
    assert loaded.example_inputs is None
    assert os.path.getsize(path) < 2 * sum(
        v.numel() * v.element_size() for v in loaded.state_dict.values())
    x = np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32)
    got = export.exported_fn(loaded)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_exported.call(jnp.asarray(x)))
    assert got.shape == want.shape == (2, HW, HW)
    assert got.dtype == want.dtype == np.int8
    mismatch = (got != want).mean()
    assert mismatch < 0.005, f'argmax mismatch fraction {mismatch:.4f}'


def test_logits_artifact_with_a_symbolic_batch_against_jax(jax_side):
    model, variables, _, ckpt, tmp = jax_side
    path = export.save_exported(
        export.export_model(_port_cfg(), imgh=HW, imgw=HW, batch=None,
                            argmax=False, ckpt_path=ckpt),
        str(tmp / 'fastscnn_logits'))
    loaded = export.load_exported(path, 'cpu')
    assert export.artifact_input_shape(loaded) == (None, HW, HW)
    fn = export.exported_fn(loaded)
    apply = jax.jit(lambda x: model.apply(variables, x, False))
    for bs in (1, 3):
        x = np.random.RandomState(bs).rand(bs, HW, HW, 3).astype(np.float32)
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(apply(jnp.asarray(x)))
        assert got.shape == (bs, HW, HW, 19)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _eager_and_module(name, seed=0):
    model = get_model(_port_cfg(model=name)).eval()
    load_jax_variables(model, flax_init_variables(model, seed))
    return (export.build_inference_fn(model, 'float32', argmax=False),
            export.InferenceModule(model, 'float32', argmax=False))


@pytest.mark.parametrize('name', ['bisenetv2', 'lednet'])
def test_interp_models_round_trip(name, tmp_path):
    """The two models whose cached interpolation matrices broke an export:
    a symbolic-batch logits artifact, saved and loaded, within 1e-5 of the
    eager forward at batch 1 and 3, the export made before any eager
    call of the model."""
    from rtseg_tpu_torch.ops.resize import interp_operator
    interp_operator.cache_clear()
    fn, module = _eager_and_module(name)
    path = export.save_exported(
        export.export_module(module, HW, 2 * HW, batch=None),
        str(tmp_path / name))
    loaded = export.exported_fn(export.load_exported(path, 'cpu'))
    for bs in (1, 3):
        x = torch.from_numpy(np.random.default_rng(bs).uniform(
            -1, 1, (bs, HW, 2 * HW, 3)).astype(np.float32))
        got, want = loaded(x), fn(x)
        assert got.shape == (bs, HW, 2 * HW, 19)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_an_export_leaves_the_interp_cache_alone():
    """Eager logits after an export are bit-equal to those before it; an
    export made with an empty cache leaves it empty, and the matrix an
    eager call then gets is a real tensor equal to the numpy operator."""
    from torch._subclasses.fake_tensor import FakeTensor
    from rtseg_tpu_torch.ops.resize import _interp_matrix, interp_operator
    fn, module = _eager_and_module('bisenetv2', seed=3)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (2, HW, 2 * HW, 3)).astype(np.float32))
    before = fn(x)
    interp_operator.cache_clear()
    export.export_module(module, HW, 2 * HW, batch=2)
    assert interp_operator.cache_info().currsize == 0
    after = fn(x)
    assert torch.equal(before, after)
    assert interp_operator.cache_info().currsize > 0
    op = interp_operator(8, HW, True, torch.float32, torch.device('cpu'))
    assert not isinstance(op, FakeTensor)
    assert torch.equal(op, torch.from_numpy(_interp_matrix(8, HW, True)))


class _Sign(torch.nn.Module):
    """A stand-in program for the batch rules: int8 masks of the first
    channel's sign."""

    def forward(self, images):
        return (images[..., 0] > 0).to(torch.int8)


def test_from_artifact_batch_rules_and_refusals(jax_side):
    _, _, _, ckpt, tmp = jax_side
    static = export.save_exported(
        export.export_module(_Sign(), 32, 48, batch=2, platforms=('cpu',)),
        str(tmp / 'static'))
    symbolic = export.save_exported(
        export.export_model(_port_cfg(), imgh=32, imgw=48, batch=None,
                            ckpt_path=ckpt), str(tmp / 'symbolic'))
    eng = ServeEngine.from_artifact(static, device='cpu')
    assert eng.buckets == [(32, 48)] and eng.batch == 2
    assert ServeEngine.from_artifact(static, batch=2, device='cpu').batch == 2
    with pytest.raises(ValueError, match=f'artifact {static} was exported '
                                         f'at batch 2, requested 4'):
        ServeEngine.from_artifact(static, batch=4, device='cpu')
    with pytest.raises(ValueError, match=f'artifact {symbolic} has a '
                                         f'symbolic batch dim; pass batch='):
        ServeEngine.from_artifact(symbolic, device='cpu')
    sym = ServeEngine.from_artifact(symbolic, batch=3, device='cpu')
    assert sym.batch == 3 and sym.stats()['executables'] == 1
    x = np.random.default_rng(1).standard_normal((3, 32, 48, 3)).astype(
        np.float32)
    assert np.array_equal(eng.run((32, 48), x[:2]),
                          (x[:2, ..., 0] > 0).astype(np.int8))
    # the artifact's masks are the from_config engine's on the same weights
    ref = ServeEngine.from_config(_port_cfg(), [(32, 48)], 3,
                                  ckpt_path=ckpt, device='cpu')
    assert np.array_equal(sym.run((32, 48), x), ref.run((32, 48), x))
    # a device the artifact was not exported for, the TPU; exe_cache
    cuda_only = export.save_exported(
        export.export_module(_Sign(), 32, 48, platforms=('cuda',)),
        str(tmp / 'cuda_only'))
    with pytest.raises(ValueError, match='exported for cuda, not cpu'):
        export.load_exported(cuda_only, 'cpu')
    for platforms in (('cpu', 'tpu'), ('tpu',)):
        with pytest.raises(ValueError, match='the port has no TPU target'):
            export.export_model(_port_cfg(), imgh=32, imgw=48,
                                platforms=platforms)
    with pytest.raises(ValueError, match='no platforms'):
        export.export_model(_port_cfg(), imgh=32, imgw=48, platforms=())
    # exe_cache is taken; the graphs launch no library of the port, so
    # nothing is acquired through it
    from rtseg_tpu_torch.warm import ExeCache
    cache = ExeCache(str(tmp / 'exe'))
    cached = ServeEngine.from_artifact(static, device='cpu', exe_cache=cache)
    assert cached.stats()['cache_hits'] == 0
    assert cache.stats()['hits'] + cache.stats()['misses'] == 0
    assert np.array_equal(cached.run((32, 48), x[:2]),
                          eng.run((32, 48), x[:2]))


def test_the_card_is_the_default(monkeypatch, jax_side):
    path = str(jax_side[4] / 'fastscnn.pt2')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        export.load_exported(path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ServeEngine.from_artifact(path)


def test_tools_export_then_serve_the_artifact(tmp_path, capsys):
    """tools/torch_export.py writes a symbolic-batch artifact of the
    default Flax init; tools/torch_segserve.py bench --artifact serves it
    on the CPU through a localhost server (in this process), --check
    passing, the bucket
    taken from the artifact; --bundle still raises."""
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import torch_export
        import torch_segserve  # noqa: F401
    finally:
        sys.path.pop(0)
    out = str(tmp_path / 'fastscnn.pt2')
    assert torch_export.main(['--model', 'fastscnn', '--num_class', '5',
                              '--compute_dtype', 'float32', '--imgh', '32',
                              '--imgw', '48', '--batch', '0', '--out',
                              out]) == 0
    assert os.path.getsize(out) > 0
    base = ['bench', '--device', 'cpu', '--compute_dtype', 'float32',
            '--num_class', '5', '--colormap', 'custom', '--artifact', out,
            '--batch', '2']
    assert torch_segserve.main(base + [
        '--requests', '8', '--rps', '40', '--check', '--via-http',
        '--p95-ms', '30000']) == 0
    stdout = capsys.readouterr().out
    assert 'torch_segserve check OK: 8/8 ok' in stdout
    assert '1 buckets' in stdout
    with pytest.raises(NotImplementedError, match='"The planes"'):
        torch_segserve.main(base + ['--bundle', 'dir'])
