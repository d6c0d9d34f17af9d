"""The port's ServeEngine against the JAX package's, on the same weights
(the JAX engine test's FastSCNN, 5 classes, float32, PRNGKey(0) init,
moved by utils/convert.py) and the same numpy images made from a seed.

Tolerance: the int8 masks equal the JAX engine's at every pixel whose
top-2 gap in the JAX float32 logits is at least 1e-4 (the model tests'
eval-logit bound); elsewhere the two argmaxes may pick either class. On
the CPU the port runs the engine's function eagerly (the card replays a
CUDA graph a bucket: chip_smoke.py). Also: batch-fill independence (a
partial and a full batch give bit-equal rows), one entry a bucket,
UnknownBucket, the sealed table, and the refusals of the planes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.export import build_inference_fn as jax_inference_fn
from rtseg_tpu.models import get_model as jax_get_model
from rtseg_tpu.serve import ServeEngine as JaxServeEngine
from rtseg_tpu_torch import export
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.serve import (Pending, SealedTable, ServeEngine,
                                   UnknownBucket, assemble_batch)

BUCKETS = [(32, 32), (48, 48)]
BATCH = 4
GAP = 1e-4


def _kw():
    return dict(dataset='synthetic', model='fastscnn', num_class=5,
                colormap='custom', compute_dtype='float32', use_tb=False)


@pytest.fixture(scope='module')
def jax_side():
    cfg = JaxSegConfig(**_kw())
    cfg.resolve(num_devices=1)
    model = jax_get_model(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32), False)
    engine = JaxServeEngine.from_config(cfg, BUCKETS, BATCH,
                                        variables=variables)
    logits = jax.jit(jax_inference_fn(model, variables, 'float32',
                                      argmax=False))
    return engine, logits, jax.device_get(variables)


@pytest.fixture(scope='module')
def engine(jax_side):
    cfg = SegConfig(**_kw())
    cfg.resolve(num_devices=1)
    return ServeEngine.from_config(cfg, BUCKETS, BATCH, variables=jax_side[2],
                                   device='cpu')


def _images(bucket, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(bucket + (3,)).astype(np.float32)
            for _ in range(n)]


def _top2_gap(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize('bucket', BUCKETS)
def test_masks_equal_the_jax_engine_where_the_logits_decide(
        engine, jax_side, bucket):
    jengine, logits, _ = jax_side
    batch = assemble_batch(_images(bucket, BATCH, sum(bucket)), bucket, BATCH)
    ours = engine.run(bucket, batch)
    theirs = np.asarray(jengine.run(bucket, batch))
    assert ours.shape == theirs.shape == (BATCH,) + bucket
    assert ours.dtype == theirs.dtype == np.int8
    decided = _top2_gap(logits(batch)) >= GAP
    assert decided.mean() > 0.99
    assert np.array_equal(ours[decided], theirs[decided])


def test_spatially_padded_requests_equal_jax(engine, jax_side):
    """Two 30x31 images padded into the 32x32 bucket and two full ones."""
    jengine, logits, _ = jax_side
    rng = np.random.default_rng(11)
    imgs = [rng.standard_normal((30, 31, 3)).astype(np.float32)
            for _ in range(2)] + _images((32, 32), 2, 12)
    batch = assemble_batch(imgs, (32, 32), BATCH)
    ours = engine.run((32, 32), batch)
    decided = _top2_gap(logits(batch)) >= GAP
    theirs = np.asarray(jengine.run((32, 32), batch))
    assert np.array_equal(ours[decided], theirs[decided])


def test_a_request_does_not_depend_on_how_full_its_batch_was(engine):
    imgs = _images((48, 48), 3, 5)
    full = engine.run((48, 48), assemble_batch(imgs + [imgs[0]], (48, 48),
                                               BATCH))
    partial = engine.run((48, 48), assemble_batch(imgs[:1], (48, 48), BATCH))
    assert np.array_equal(full[0], partial[0])
    assert np.array_equal(full[0], full[3])


def test_the_table_holds_one_entry_a_bucket_and_is_sealed(jax_side):
    cfg = SegConfig(**_kw())
    eng = ServeEngine.from_config(cfg, BUCKETS + [(32, 32)], BATCH,
                                  variables=jax_side[2], device='cpu')
    s = eng.stats()
    assert s['executables'] == len(BUCKETS) and s['retraces'] == 0
    assert s['batch'] == BATCH and s['buckets'] == ['32x32', '48x48']
    assert s['cuda_graphs'] == 0                 # eager on the CPU
    with pytest.raises(UnknownBucket):
        eng.dispatch((64, 64), np.zeros((BATCH, 64, 64, 3), np.float32))
    with pytest.raises(UnknownBucket, match='no bucket fits 64x64'):
        eng.select(64, 64)
    with pytest.raises(ValueError, match='is not the bucket'):
        eng.dispatch((32, 32), np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(SealedTable, match='sealed'):
        eng.capture((64, 64))
    assert eng.stats()['retraces'] == 1
    assert eng.stats()['executables'] == len(BUCKETS)
    eng.run((32, 32), np.zeros((BATCH, 32, 32, 3), np.float32))
    assert eng.stats()['calls'] == {'32x32': 1, '48x48': 0}
    assert eng.stats()['images'] == BATCH


def test_dispatch_returns_a_handle_read_once(engine):
    handle = engine.dispatch((32, 32), np.zeros((BATCH, 32, 32, 3),
                                                np.float32))
    assert isinstance(handle, Pending)
    first = handle.result()
    assert handle.result() is first


def test_engine_refusals(jax_side):
    """Parallel bucket builds (compile_workers above 0) raise, naming "The
    planes"; the executable cache and its pins are taken and checked
    (tests/test_torch_warm.py); export and from_artifact are ported
    (tests/test_torch_export.py), and the export refuses the TPU."""
    cfg = SegConfig(**_kw())
    with pytest.raises(NotImplementedError, match='"The planes"'):
        ServeEngine(lambda x: x, BUCKETS, BATCH, device='cpu',
                    compile_workers=4)
    with pytest.raises(ValueError, match='unknown'):
        ServeEngine(lambda x: x, BUCKETS, BATCH, device='cpu',
                    pins={'bn_axis': None, 's2d_stem': False,
                          'defer_upsample': False, 'remat': True})
    with pytest.raises(ValueError, match='the port has no TPU target'):
        export.export_model(cfg, platforms=('cpu', 'tpu'))
    with pytest.raises(ValueError, match='at least one bucket'):
        ServeEngine(lambda x: x, [], BATCH, device='cpu')
    with pytest.raises(ValueError, match='batch must be'):
        ServeEngine(lambda x: x, BUCKETS, 0, device='cpu')


def test_the_card_is_the_default(monkeypatch, jax_side):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine.from_config(SegConfig(**_kw()), BUCKETS, BATCH,
                                variables=jax_side[2])


def test_inference_fn_logits_equal_jax(engine, jax_side):
    """argmax=False gives the float32 logits; held to JAX's within the
    model tests' 1e-4."""
    from rtseg_tpu_torch.models.registry import get_model
    from rtseg_tpu_torch.utils.convert import load_jax_variables
    cfg = SegConfig(**_kw())
    model = get_model(cfg).eval()
    load_jax_variables(model, jax_side[2])
    fn = export.build_inference_fn(model, 'float32', argmax=False)
    x = np.stack(_images((32, 32), 2, 3))
    got = fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 32, 32, 5)
    np.testing.assert_allclose(got, np.asarray(jax_side[1](x)), atol=1e-4)
    with pytest.raises(ValueError, match='eval mode'):
        export.build_inference_fn(model.train(), 'float32')


def test_from_config_reads_a_port_checkpoint(engine, jax_side, tmp_path):
    """--ckpt: a checkpoint of the port gives the engine built from the
    same variables; an orbax directory of the JAX package raises."""
    from rtseg_tpu_torch.models.registry import get_model
    from rtseg_tpu_torch.train.checkpoint import save_best_ckpt
    from rtseg_tpu_torch.train.state import TrainState
    from rtseg_tpu_torch.utils.convert import load_jax_variables
    cfg = SegConfig(**_kw())
    model = get_model(cfg)
    load_jax_variables(model, jax_side[2])
    ckpt = str(tmp_path / 'best.ckpt')
    save_best_ckpt(ckpt, TrainState(0, model, None, model), 1, 0.0)
    from_ckpt = ServeEngine.from_config(cfg, BUCKETS, BATCH, ckpt_path=ckpt,
                                        device='cpu')
    batch = assemble_batch(_images((48, 48), 2, 9), (48, 48), BATCH)
    assert np.array_equal(from_ckpt.run((48, 48), batch),
                          engine.run((48, 48), batch))
    (tmp_path / 'orbax').mkdir()
    (tmp_path / 'orbax' / 'meta.json').write_text('{}')
    with pytest.raises(FileNotFoundError, match='not a checkpoint of the'):
        ServeEngine.from_config(cfg, BUCKETS, BATCH,
                                ckpt_path=str(tmp_path / 'orbax'),
                                device='cpu')


def test_concurrent_dispatches_are_exact():
    """More threads than cores run batches through one engine at once
    (switch interval shortened): every thread gets its own batch's masks
    and the call and image counters lose no update."""
    import sys
    import threading
    eng = ServeEngine(lambda x: x[..., 0].to(torch.int8), BUCKETS, 2,
                      device='cpu')
    n_threads, n_runs, bad = 16, 40, []

    def work(t):
        rng = np.random.default_rng(t)
        for i in range(n_runs):
            bucket = BUCKETS[i % 2]
            x = rng.integers(-100, 100, (2,) + bucket + (3,)).astype(
                np.float32)
            if not np.array_equal(eng.run(bucket, x), x[..., 0]):
                bad.append((t, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    s = eng.stats()
    assert sum(s['calls'].values()) == n_threads * n_runs
    assert s['images'] == 2 * n_threads * n_runs
