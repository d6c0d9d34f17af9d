"""The host code of serving and prediction in the port against the JAX
package, on the same inputs in the same process: the colormap, the
bucket helpers, the test folder (TestFolder: len, header-only shape, the
decoded and normalized image bit-equal), the Prometheus text of the
metrics registry (identical after the same operations), the flight
recorder's traffic mix, the micro-batcher's cases of
tests/test_segserve.py run against the port's batcher, and PIL's NEAREST
resize written out in numpy (bit-equal to PIL)."""

import os
import time

import numpy as np
import pytest
from PIL import Image

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data.test_folder import TestFolder as JaxTestFolder
from rtseg_tpu.obs import flight as jflight
from rtseg_tpu.obs import metrics as jmetrics
from rtseg_tpu.serve import engine as jengine
from rtseg_tpu.utils.colormap import get_colormap as jax_colormap
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import get_test_loader, png
from rtseg_tpu_torch.data.transforms import resize_nearest_pil
from rtseg_tpu_torch.obs import flight, metrics
from rtseg_tpu_torch.serve import (MicroBatcher, ServeDrop, ServeReject,
                                   UnknownBucket, engine)
from rtseg_tpu_torch.utils import get_colormap

BUCKETS = [(32, 32), (48, 48)]


@pytest.mark.parametrize('name,num_class', [
    ('cityscapes', 19), ('custom', 5), ('custom', 40), ('random', 3),
    ('random', 255)])
def test_colormap_equals_jax(name, num_class):
    cfg = dict(colormap=name, num_class=num_class)
    got = get_colormap(SegConfig(**cfg))
    assert got.shape == (256, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jax_colormap(JaxSegConfig(**cfg)))


def test_colormap_refuses_what_jax_refuses():
    with pytest.raises(NotImplementedError, match='Unsupported colormap'):
        get_colormap(SegConfig(colormap='viridis'))


@pytest.mark.parametrize('spec', ['512x1024, 256x512', '64x64,32x32,',
                                  '1024x2048'])
def test_parse_buckets_equals_jax(spec):
    assert engine.parse_buckets(spec) == jengine.parse_buckets(spec)


def test_parse_buckets_refuses_an_empty_spec():
    with pytest.raises(ValueError, match='no buckets'):
        engine.parse_buckets(' , ')


@pytest.mark.parametrize('hw', [(20, 20), (33, 20), (40, 100), (65, 10),
                                (64, 128), (1, 1)])
def test_select_bucket_equals_jax(hw):
    buckets = [(64, 64), (32, 32), (64, 128)]
    assert engine.select_bucket(buckets, *hw) \
        == jengine.select_bucket(buckets, *hw)


def test_assemble_batch_equals_jax():
    rng = np.random.default_rng(0)
    imgs = [rng.standard_normal((h, w, 3)).astype(np.float32)
            for h, w in ((3, 4), (5, 5), (8, 8))]
    got = engine.assemble_batch(imgs, (8, 8), 4)
    assert got.dtype == np.float32
    assert np.array_equal(got, jengine.assemble_batch(imgs, (8, 8), 4))
    with pytest.raises(engine.UnknownBucket):
        engine.assemble_batch([np.zeros((9, 4, 3), np.float32)], (8, 8), 4)
    with pytest.raises(ValueError):
        engine.assemble_batch(imgs * 2, (8, 8), 4)


# -------------------------------------------------------------- TestFolder

def _folder(tmp_path, shapes, seed=0):
    """PNGs at `shapes`, alternately written by PIL and by the port's
    encoder with its filter types cycled."""
    rng = np.random.default_rng(seed)
    folder = tmp_path / 'imgs'
    folder.mkdir()
    for i, (h, w) in enumerate(shapes):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = folder / f'{i:02d}_img.png'
        if i % 2:
            path.write_bytes(png.encode(image, (0, 1, 2, 3, 4)))
        else:
            Image.fromarray(image).save(path)
    return str(folder)


@pytest.mark.parametrize('scale', [1.0, 0.75, 0.3])
def test_test_folder_equals_jax(tmp_path, scale):
    folder = _folder(tmp_path, [(40, 56), (31, 47), (40, 56), (17, 90)])
    kw = dict(is_testing=True, test_data_folder=folder, scale=scale)
    cfg = SegConfig(**kw)
    ours = get_test_loader(cfg)
    theirs = JaxTestFolder(JaxSegConfig(**kw))
    assert len(ours) == len(theirs) == cfg.test_num == 4
    for i in range(len(ours)):
        assert ours.shape(i) == theirs.shape(i)
        raw, aug, name = ours.get(i)
        jraw, jaug, jname = theirs.get(i)
        assert name == jname
        assert np.array_equal(raw, jraw)
        assert aug.dtype == jaug.dtype == np.float32
        assert aug.shape[:2] == ours.shape(i)
        assert np.array_equal(aug.view(np.uint32), jaug.view(np.uint32))


def test_test_folder_refuses_a_jpeg_and_a_missing_folder(tmp_path):
    """A JPEG is read since the port decodes JPEGs (the same image and
    shape as the JAX TestFolder's); a GIF and a missing folder raise."""
    folder = _folder(tmp_path, [(16, 16)])
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (8, 8, 3), dtype=np.uint8)).save(
        os.path.join(folder, 'b.jpg'))
    cfg = SegConfig(is_testing=True, test_data_folder=folder)
    ours = get_test_loader(cfg)
    theirs = JaxTestFolder(JaxSegConfig(is_testing=True,
                                        test_data_folder=folder))
    assert ours.img_names == theirs.img_names == ['00_img.png', 'b.jpg']
    assert ours.shape(1) == theirs.shape(1) == (8, 8)
    for a, b in zip(ours.get(1)[:2], theirs.get(1)[:2]):
        assert np.array_equal(a, b)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        os.path.join(folder, 'c.gif'))
    with pytest.raises(NotImplementedError,
                       match=r'c\.gif is neither a PNG nor a JPEG'):
        get_test_loader(cfg)
    with pytest.raises(RuntimeError, match='does not exist'):
        get_test_loader(SegConfig(is_testing=True,
                                  test_data_folder=str(tmp_path / 'nope')))


def test_read_size_reads_the_header_alone(tmp_path):
    folder = _folder(tmp_path, [(23, 71)])
    path = os.path.join(folder, os.listdir(folder)[0])
    data = open(path, 'rb').read()
    cut = tmp_path / 'cut.png'
    cut.write_bytes(data[:33])            # IHDR only: no pixel data
    assert png.read_size(str(cut)) == (23, 71)


# ------------------------------------------------------------ PIL NEAREST

@pytest.mark.parametrize('hw,size', [
    ((1024, 2048), (720, 1280)), ((720, 1280), (1024, 2048)),
    ((7, 13), (100, 3)), ((3, 5), (7, 11)), ((100, 100), (33, 77)),
    ((5, 1), (1, 5)), ((1, 1), (9, 9)), ((513, 1025), (1024, 2048)),
    ((37, 41), (37, 41)), ((250, 250), (249, 251)), ((96, 160), (64, 97))])
def test_nearest_resize_is_bit_equal_to_pil(hw, size):
    """Upscales, downscales and odd ratios, RGB and gray."""
    rng = np.random.default_rng(sum(hw) + sum(size))
    for shape in (hw + (3,), hw):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(Image.fromarray(a).resize(size[::-1],
                                                    Image.NEAREST))
        got = resize_nearest_pil(a, size[1], size[0])
        assert got.shape == want.shape
        assert np.array_equal(got, want)


def test_nearest_resize_matches_pil_at_random_ratios():
    rng = np.random.default_rng(7)
    for _ in range(60):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 200, 4))
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(a).resize((nw, nh),
                                                    Image.NEAREST))
        assert np.array_equal(resize_nearest_pil(a, nw, nh), want), \
            (h, w, nh, nw)


# --------------------------------------------------------------- metrics

def _drive(mod):
    """The same sequence of operations on a registry of `mod`."""
    reg = mod.MetricsRegistry()
    ok = reg.counter('serve_requests_total', help='terminal outcomes',
                     status='ok')
    err = reg.counter('serve_requests_total', status='error')
    depth = reg.gauge('serve_queue_depth', help='queued requests')
    e2e = reg.histogram('serve_request_e2e_ms', exemplars=3,
                        help='end-to-end latency (ms)')
    stage = reg.histogram('serve_stage_ms', stage='queue', window=8)
    rng = np.random.default_rng(3)
    for i in range(40):
        ok.inc()
        if i % 7 == 0:
            err.inc(2)
        depth.set(i % 5)
        v = float(rng.exponential(30.0))
        e2e.observe(v, exemplar=f'{i:016x}')
        stage.observe(v / 3)
    e2e.observe(1.0)                      # a bound: its own bucket
    depth.add(0.5)
    reg.gauge('device_memory_bytes', kind='peak_bytes_in_use').set(2 ** 31)
    return reg


def test_prometheus_text_equals_jax():
    ours, theirs = _drive(metrics), _drive(jmetrics)
    text = metrics.render_prometheus(ours)
    assert text == jmetrics.render_prometheus(theirs)
    assert '# {trace_id="' in text and 'serve_stage_ms_window' in text
    assert ours.snapshot() == theirs.snapshot()


def test_quantiles_and_a_disabled_registry_equal_jax():
    vals = sorted(np.random.default_rng(1).random(17).tolist())
    qs = (0.0, 0.5, 0.95, 0.99, 1.0)
    assert metrics.quantiles_of(vals, qs) == jmetrics.quantiles_of(vals, qs)
    off = metrics.MetricsRegistry(enabled=False)
    off.counter('x').inc()
    off.histogram('y').observe(3.0)
    assert metrics.render_prometheus(off) == '\n'
    reg = metrics.MetricsRegistry()
    reg.counter('z')
    with pytest.raises(ValueError, match='already registered'):
        reg.gauge('z', kind='other labels')


def test_traffic_mix_equals_jax():
    rng = np.random.default_rng(5)
    recs = [{'ts': 100.0 + i * 0.01, 'bucket': ('32x32', '48x48')[i % 2],
             'e2e_ms': float(rng.exponential(20.0)),
             'deadline_ms': (50.0 if i % 3 else None)} for i in range(30)]
    assert flight.traffic_mix(recs) == jflight.traffic_mix(recs)
    ring = flight.FlightRecorder(capacity=4)
    for r in recs[:6]:
        ring.record(r)
    assert ring.snapshot() == recs[2:6] and len(ring) == 4
    out = ring.dump('test', sink=None)
    assert out['records'] == 4 and out['dump_records'] == recs[2:6]


# ---------------------------------------------------------------- batcher
# the cases of tests/test_segserve.py, against the port's batcher

def test_batcher_coalesces_full_batch():
    b = MicroBatcher(BUCKETS, max_batch=4, max_wait_ms=500, max_queue=16)
    futs = [b.submit(np.zeros((32, 32, 3), np.float32)) for _ in range(4)]
    t0 = time.perf_counter()
    bucket, reqs = b.get_batch(timeout=1.0)
    assert time.perf_counter() - t0 < 0.4
    assert bucket == (32, 32) and len(reqs) == 4
    assert all(not f.done() for f in futs)
    assert b.stats()['batches'] == 1


def test_batcher_releases_partial_batch_after_wait():
    b = MicroBatcher(BUCKETS, max_batch=4, max_wait_ms=20, max_queue=16)
    b.submit(np.zeros((32, 32, 3), np.float32))
    b.submit(np.zeros((30, 31, 3), np.float32))
    bucket, reqs = b.get_batch(timeout=2.0)
    assert bucket == (32, 32) and len(reqs) == 2
    assert reqs[0].hw == (32, 32) and reqs[1].hw == (30, 31)


def test_batcher_batches_are_bucket_homogeneous_and_oldest_first():
    b = MicroBatcher(BUCKETS, max_batch=4, max_wait_ms=5, max_queue=16)
    b.submit(np.zeros((48, 48, 3), np.float32))
    b.submit(np.zeros((32, 32, 3), np.float32))
    b.submit(np.zeros((48, 48, 3), np.float32))
    first, reqs1 = b.get_batch(timeout=1.0)
    assert first == (48, 48) and len(reqs1) == 2
    second, reqs2 = b.get_batch(timeout=1.0)
    assert second == (32, 32) and len(reqs2) == 1


def test_batcher_deadline_drops():
    b = MicroBatcher(BUCKETS, max_batch=4, max_wait_ms=5, max_queue=16)
    fut = b.submit(np.zeros((32, 32, 3), np.float32), deadline_ms=1.0)
    time.sleep(0.02)
    assert b.get_batch(timeout=0.05) is None
    assert b.stats()['dropped'] == 1
    with pytest.raises(ServeDrop):
        fut.result(timeout=1.0)


def test_batcher_backpressure_and_unknown_bucket():
    b = MicroBatcher(BUCKETS, max_batch=4, max_wait_ms=5000, max_queue=2)
    b.submit(np.zeros((32, 32, 3), np.float32))
    b.submit(np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ServeReject):
        b.submit(np.zeros((32, 32, 3), np.float32))
    assert b.stats()['rejected'] == 1
    with pytest.raises(UnknownBucket):
        b.submit(np.zeros((64, 64, 3), np.float32))
    b.close()
    with pytest.raises(ServeReject):
        b.submit(np.zeros((32, 32, 3), np.float32))


def test_batcher_metrics_equal_jax_after_the_same_traffic():
    """The same admissions, rejections and batches give the same counter
    text (histograms carry timings, so only the counters compare)."""
    from rtseg_tpu.serve import MicroBatcher as JaxBatcher
    texts = []
    for cls, mod in ((MicroBatcher, metrics), (JaxBatcher, jmetrics)):
        reg = mod.MetricsRegistry()
        b = cls(BUCKETS, max_batch=2, max_wait_ms=0, max_queue=3,
                registry=reg, trace=False)
        for hw in ((32, 32), (48, 48), (20, 20)):
            b.submit(np.zeros(hw + (3,), np.float32))
        with pytest.raises(RuntimeError, match='queue full'):
            b.submit(np.zeros((32, 32, 3), np.float32))
        b.close()
        while b.get_batch(timeout=0.5) is not None:
            pass
        texts.append([line for line in mod.render_prometheus(reg).split('\n')
                      if line.startswith(('serve_requests_total',
                                          'serve_batches', 'serve_batched',
                                          'serve_padded', 'serve_admitted'))])
    assert texts[0] == texts[1] and texts[0]
