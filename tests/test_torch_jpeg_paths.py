"""JPEGs through the port's data paths against the JAX package's, which
opens them with PIL: a Custom set of JPEG images (PNG masks) gives the
same files and the same samples under the same seeds, train and eval
transforms, with and without colour jitter (as
tests/test_torch_data_sets.py does for PNGs); TestFolder's header-only
shape and `get` equal JAX's on a folder of JPEGs; the server's
preprocess of a JPEG body equals the JAX server's, and a JPEG body served
by the port over HTTP answers the engine's mask of PIL's decode."""

import io
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from rtseg_tpu.config import SegConfig as JaxSegConfig
from rtseg_tpu.data.custom import Custom as JaxCustom
from rtseg_tpu.data.test_folder import TestFolder as JaxTestFolder
from rtseg_tpu.serve.server import make_preprocess as jax_preprocess
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import get_test_loader, png
from rtseg_tpu_torch.data.custom import Custom
from rtseg_tpu_torch.data.transforms import EvalTransform
from rtseg_tpu_torch.obs import MetricsRegistry
from rtseg_tpu_torch.serve import (ServeEngine, ServePipeline,
                                   assemble_batch, make_preprocess,
                                   make_server)
from rtseg_tpu_torch.utils import get_colormap

AUG = dict(randscale=(-0.5, 1.0), h_flip=0.5, crop_size=32)
# (height, width, PIL save options) of the set's images
IMAGES = [(40, 50, dict(quality=90)),
          (33, 47, dict(progressive=True, subsampling=1)),
          (40, 50, dict(subsampling=0, restart_marker_blocks=2)),
          (25, 61, dict(quality=70, optimize=True))]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpeg_bytes(rng, h, w, **opts) -> bytes:
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    a = 128 + 90 * np.sin(6 * x + 3 * y + np.arange(3)) \
        + rng.normal(0, 20, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(a, 0, 255).astype(np.uint8)).save(buf, 'JPEG',
                                                              **opts)
    return buf.getvalue()


@pytest.fixture(scope='module')
def jpeg_tree(tmp_path_factory):
    """<root>/data.yaml and <root>/<mode>/imgs/*.jpg with masks/*.png."""
    root = tmp_path_factory.mktemp('jpeg_custom')
    rng = np.random.default_rng(11)
    for mode, n in (('train', 4), ('val', 3)):
        os.makedirs(root / mode / 'imgs')
        os.makedirs(root / mode / 'masks')
        for i in range(n):
            h, w, opts = IMAGES[i % len(IMAGES)]
            (root / mode / 'imgs' / f'{i}.jpg').write_bytes(
                _jpeg_bytes(rng, h, w, **opts))
            (root / mode / 'masks' / f'{i}.png').write_bytes(png.encode(
                rng.integers(0, 3, (h, w), dtype=np.uint8)))
    (root / 'data.yaml').write_text(
        f'path: {root}\nnames:\n  0: a\n  1: b\n  2: c\n')
    return str(root)


@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('jitter', [0.0, 0.5])
def test_custom_jpeg_samples_equal_the_jax_packages(jpeg_tree, mode,
                                                    jitter):
    base = dict(dataset='custom', data_root=jpeg_tree, train_size=48,
                test_size=40, brightness=jitter, contrast=jitter,
                saturation=jitter, **AUG)
    ours = Custom(SegConfig(**base).resolve(), mode)
    theirs = JaxCustom(JaxSegConfig(**base).resolve(), mode)
    assert ours.images == theirs.images and ours.masks == theirs.masks
    assert all(p.endswith('.jpg') for p in ours.images)
    for i in range(len(ours)):
        for a, b in zip(ours.prepare(i), theirs.prepare(i)):
            np.testing.assert_array_equal(a, b)
        for seed in (0, 1):
            got = ours.get(i, np.random.default_rng((seed, i)))
            want = theirs.get(i, np.random.default_rng((seed, i)))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('scale', [1.0, 0.75])
def test_test_folder_of_jpegs_equals_jax(tmp_path, scale):
    rng = np.random.default_rng(3)
    for i, (h, w, opts) in enumerate(IMAGES):
        (tmp_path / f'{i}.jpg').write_bytes(_jpeg_bytes(rng, h, w, **opts))
    kw = dict(is_testing=True, test_data_folder=str(tmp_path), scale=scale)
    ours = get_test_loader(SegConfig(**kw))
    theirs = JaxTestFolder(JaxSegConfig(**kw))
    assert len(ours) == len(theirs) == len(IMAGES)
    for i in range(len(ours)):
        assert ours.shape(i) == theirs.shape(i)
        raw, aug, name = ours.get(i)
        jraw, jaug, jname = theirs.get(i)
        assert name == jname
        assert np.array_equal(raw, jraw)
        assert np.array_equal(aug.view(np.uint32), jaug.view(np.uint32))


@pytest.fixture(scope='module')
def cfg():
    c = SegConfig(dataset='synthetic', model='fastscnn', num_class=5,
                  colormap='custom', compute_dtype='float32', use_tb=False)
    c.resolve(num_devices=1)
    return c


def test_preprocess_of_a_jpeg_body_equals_the_jax_servers(cfg):
    jcfg = JaxSegConfig(dataset='synthetic', model='fastscnn', num_class=5)
    jcfg.resolve(num_devices=1)
    rng = np.random.default_rng(4)
    for h, w, opts in IMAGES:
        body = _jpeg_bytes(rng, h, w, **opts)
        got = make_preprocess(cfg)(body)
        want = jax_preprocess(jcfg)(body)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_a_jpeg_body_served_answers_the_engines_mask(cfg):
    engine = ServeEngine.from_config(cfg, [(32, 32), (48, 64)], 2,
                                     device='cpu')
    pipe = ServePipeline(engine, max_wait_ms=2.0,
                         preprocess=make_preprocess(cfg),
                         registry=MetricsRegistry())
    srv = make_server(pipe, port=0, colormap=get_colormap(cfg))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f'http://127.0.0.1:{srv.server_address[1]}/predict?raw=1'
    transform = EvalTransform(cfg)
    rng = np.random.default_rng(5)
    try:
        for h, w, opts in IMAGES:
            body = _jpeg_bytes(rng, h, w, **opts)
            req = urllib.request.Request(url, data=body, method='POST')
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                got = np.frombuffer(resp.read(), np.int8).reshape(h, w)
            pil = np.asarray(Image.open(io.BytesIO(body)).convert('RGB'))
            bucket = engine.select(h, w)
            want = engine.run(bucket, assemble_batch(
                [transform(pil, None, None)], bucket, 2))[0, :h, :w]
            assert np.array_equal(got, want)
    finally:
        srv.shutdown()
        srv.server_close()
        pipe.close()
        t.join(timeout=10)
