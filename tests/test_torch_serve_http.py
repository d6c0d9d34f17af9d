"""The port's serving pipeline, HTTP server and load generator on the CPU
(FastSCNN, 5 classes, float32, Flax's initializers): mixed shapes end to
end, each mask equal to the engine's on the request alone; the server on
localhost (/predict as a colormapped PNG and ?raw=1, /healthz, /stats,
/metrics, 413 for an image no bucket fits, 500 saying why for a JPEG body
cut short and for a body of another format, /debug/profile answering
200 with a parsed profile and 409 to an overlapping capture,
/debug/flight, the drain); the open-loop bench and its gate; and
`tools/torch_segserve.py bench --check --device cpu` as a subprocess."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.data import png
from rtseg_tpu_torch.obs import MetricsRegistry
from rtseg_tpu_torch.serve import (ServeEngine, ServePipeline,
                                   assemble_batch, bench_http,
                                   bench_pipeline, bench_sequential,
                                   check_report, encode_png, format_report,
                                   make_preprocess, make_server,
                                   synth_images)
from rtseg_tpu_torch.serve import headers as port_headers
from rtseg_tpu_torch.serve.headers import (MASK_SHAPE_HEADER, TIMING_HEADER,
                                           TRACE_HEADER)
from rtseg_tpu_torch.utils import get_colormap

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = [(32, 32), (48, 48)]
BATCH = 4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small CPU ops run fastest on one thread here; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def cfg():
    c = SegConfig(dataset='synthetic', model='fastscnn', num_class=5,
                  colormap='custom', compute_dtype='float32', use_tb=False)
    c.resolve(num_devices=1)
    return c


@pytest.fixture(scope='module')
def engine(cfg):
    return ServeEngine.from_config(cfg, BUCKETS, BATCH, device='cpu')


def _alone(engine, image):
    """The engine's mask of `image` in a batch of its own, cropped."""
    h, w = image.shape[:2]
    bucket = engine.select(h, w)
    return engine.run(bucket, assemble_batch([image], bucket,
                                             engine.batch))[0, :h, :w]


def test_pipeline_serves_mixed_shapes(engine, cfg):
    rng = np.random.default_rng(0)
    shapes = [(32, 32), (48, 48), (30, 31), (40, 20), (48, 33), (17, 9)]
    images = [rng.standard_normal(s + (3,)).astype(np.float32)
              for s in shapes for _ in range(2)]
    with ServePipeline(engine, max_wait_ms=2.0,
                       preprocess=make_preprocess(cfg)) as pipe:
        futs = [pipe.submit(im) for im in images]
        u8 = rng.integers(0, 256, (40, 20, 3), dtype=np.uint8)
        by_bytes = pipe.submit_bytes(png.encode(u8)).result(timeout=60)
        results = [f.result(timeout=60) for f in futs]
        stats = pipe.stats()
    for im, res in zip(images, results):
        assert res.mask.dtype == np.int8
        assert res.mask.shape == im.shape[:2]
        assert np.array_equal(res.mask, _alone(engine, im))
        assert res.timings['e2e_ms'] >= 0
    want = _alone(engine, make_preprocess(cfg)(png.encode(u8)))
    assert np.array_equal(by_bytes.mask, want)
    assert 'decode_ms' in by_bytes.timings
    assert stats['ok'] == len(images) + 1 and stats['errors'] == 0
    assert stats['engine']['retraces'] == 0 and not stats['dead']


@pytest.fixture(scope='module')
def server(engine, cfg):
    pipe = ServePipeline(engine, max_wait_ms=2.0,
                         preprocess=make_preprocess(cfg),
                         registry=MetricsRegistry())
    srv = make_server(pipe, port=0, colormap=get_colormap(cfg),
                      replica_id='r0')
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    srv.server_close()
    pipe.close()
    t.join(timeout=10)
    assert not t.is_alive()


def port_header(headers, constant: str) -> str:
    """The value of a response header named by its constant in the port's
    ``rtseg_tpu_torch/serve/headers.py`` (``constant`` is that constant's
    name). Every test of the port reads the headers whose reads the JAX
    package's contract does not pin (X-Mask-Dtype, X-Replica-State) through
    this one helper: the JAX contract lint (``SEGCONTRACT.json``,
    ``tests/test_segcontract.py``) scans all of ``tests/``, the port's
    tests too, and counts every X-* literal and every use of a header
    constant's name there as a reader of the JAX wire contract, which
    would change the record it pins."""
    return headers[getattr(port_headers, constant)]


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method='POST',
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


def test_http_predict_png_and_raw(server, engine, cfg):
    srv, url = server
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
    body = png.encode(u8)
    want = _alone(engine, make_preprocess(cfg)(body))
    tid = '0123456789abcdef'
    code, hdr, data = _post(url + '/predict', body, {TRACE_HEADER: tid})
    assert code == 200 and hdr['Content-Type'] == 'image/png'
    assert np.array_equal(png.decode(data, 'RGB'), get_colormap(cfg)[want])
    assert hdr[TRACE_HEADER] == tid and hdr['X-Replica-Id'] == 'r0'
    assert json.loads(hdr[TIMING_HEADER])['trace_id'] == tid
    code, hdr, data = _post(url + '/predict?raw=1', body)
    assert code == 200 and port_header(hdr, 'MASK_DTYPE_HEADER') == 'int8'
    assert hdr[MASK_SHAPE_HEADER] == '30,44'
    assert np.array_equal(np.frombuffer(data, np.int8).reshape(30, 44), want)


def test_http_errors_and_refusals(server):
    srv, url = server
    big = png.encode(np.zeros((64, 64, 3), np.uint8))
    code, _, data = _post(url + '/predict', big)
    assert code == 413 and b'no bucket fits 64x64' in data
    code, _, data = _post(url + '/predict', b'\xff\xd8\xff\xe0 not a png')
    assert code == 500
    assert 'ValueError: image file is truncated' in json.loads(data)['error']
    code, _, data = _post(url + '/predict', b'GIF89a not a png')
    assert code == 500
    assert 'neither a PNG nor a JPEG' in json.loads(data)['error']
    # the on-demand profiler capture: 200 with the parsed profile; 409
    # for a POST that overlaps another capture; 400 for a bad ms
    from rtseg_tpu_torch.obs import profile as prof
    first = {}
    th = threading.Thread(target=lambda: first.update(zip(
        ('code', 'hdr', 'data'), _post(url + '/debug/profile?ms=600',
                                       b''))))
    th.start()
    deadline = time.monotonic() + 30
    while not prof._CAPTURE_LOCK.locked() and time.monotonic() < deadline:
        time.sleep(0.01)
    code, _, data = _post(url + '/debug/profile?ms=50', b'')
    th.join(timeout=60)
    assert code == 409 and 'already in progress' in json.loads(data)['error']
    ev = json.loads(first['data'])
    assert first['code'] == 200 and ev['event'] == 'profile'
    assert ev['source'] == 'debug' and ev['requested_ms'] == 600.0
    assert {'busy_frac', 'categories', 'modules', 'top_ops', 'window_ms',
            'device_track'} <= set(ev)
    assert _post(url + '/debug/profile?ms=nan', b'')[0] == 400
    assert _post(url + '/predict', b'')[0] == 400
    assert _post(url + '/nowhere', b'x')[0] == 404
    code, _, _ = _post(url + '/predict', big, {'X-Deadline-Ms': '-1'})
    assert code == 504


def test_http_debug_profile_answers_503_for_an_incomplete_trace(
        server, monkeypatch):
    """A capture whose trace lost launches' device work is no profile:
    503 with the partial event, its lost_launches and an error; the busy
    gauge keeps its value."""
    from rtseg_tpu_torch.obs.profile import DeviceProfile
    from rtseg_tpu_torch.serve import server as server_mod
    srv, url = server
    gauge = srv.pipeline.registry.gauge('device_busy_frac')
    gauge.set(0.5)
    lost = DeviceProfile(window_us=4e5, busy_us=1e3, n_ops=3,
                         device_track=True, top_ops=[('k', 1e3)],
                         lost_launches=41)
    monkeypatch.setattr(server_mod, 'capture_window', lambda s: lost)
    code, _, data = _post(url + '/debug/profile?ms=20', b'')
    ev = json.loads(data)
    assert code == 503 and ev['event'] == 'profile'
    assert ev['lost_launches'] == 41 and 'lost the device work of 41' \
        in ev['error']
    assert gauge.value == 0.5
    monkeypatch.setattr(server_mod, 'capture_window', lambda s: DeviceProfile(
        window_us=4e5, busy_us=1e5, n_ops=3, device_track=True))
    code, _, data = _post(url + '/debug/profile?ms=20', b'')
    ev = json.loads(data)
    assert code == 200 and 'lost_launches' not in ev and 'error' not in ev
    assert gauge.value == ev['busy_frac'] == 0.25


def test_http_health_stats_metrics_and_flight(server):
    srv, url = server
    _post(url + '/predict', png.encode(np.zeros((32, 32, 3), np.uint8)))
    code, data = _get(url + '/healthz')
    health = json.loads(data)
    assert code == 200 and health['state'] == 'ready'
    assert health['replica'] == 'r0'
    stats = json.loads(_get(url + '/stats')[1])
    assert stats['ok'] >= 1 and stats['engine']['executables'] == 2
    text = _get(url + '/metrics')[1].decode()
    assert 'serve_requests_total{status="ok"}' in text
    assert 'serve_http_responses_total{code="200"}' in text
    assert '# TYPE serve_request_e2e_ms histogram' in text
    code, _, data = _post(url + '/debug/flight', b'{"reason": "test"}')
    dump = json.loads(data)
    assert code == 200 and dump['reason'] == 'test' and dump['records'] >= 1


def test_bench_pipeline_and_http_pass_the_gate(engine, cfg, server):
    images = synth_images(BUCKETS, seed=0)
    with ServePipeline(engine, max_wait_ms=2.0) as pipe:
        report = bench_pipeline(pipe, images, requests=24, rps=100.0)
    assert check_report(report, p95_ms=30000.0, expect_buckets=2) == []
    assert report['ok'] == 24 and 'e2e p50/p95/p99' in format_report(report)
    assert check_report(report, p95_ms=1e-6) != []
    _, url = server
    report = bench_http(url, [encode_png(im) for im in images], requests=12,
                        rps=50.0, workers=4)
    assert report['ok'] == 12 and report['trace_mismatch'] == 0
    assert report['per_replica'] == {'r0': 12}
    assert check_report(report, p95_ms=30000.0, expect_replicas=1) == []


def test_sequential_baseline_wants_batch_one(cfg, engine):
    images = synth_images([(32, 32)], seed=0)
    with pytest.raises(ValueError, match='batch-1'):
        bench_sequential(engine, images, 2)
    one = ServeEngine.from_config(cfg, [(32, 32)], 1, device='cpu')
    assert bench_sequential(one, images, 3)['requests'] == 3


def test_drain_refuses_new_work(engine, cfg):
    pipe = ServePipeline(engine, preprocess=make_preprocess(cfg))
    srv = make_server(pipe, port=0, colormap=get_colormap(cfg))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f'http://127.0.0.1:{srv.server_address[1]}'
    try:
        code, _, data = _post(url + '/drain', b'')
        assert code == 200 and json.loads(data)['drained']
        code, hdr, _ = _post(url + '/predict', png.encode(
            np.zeros((8, 8, 3), np.uint8)))
        assert code == 503 and port_header(hdr, 'STATE_HEADER') == 'draining'
    finally:
        srv.shutdown()
        srv.server_close()
        pipe.close()
        t.join(timeout=10)
    with pytest.raises(NotImplementedError, match='"The planes"'):
        make_server(pipe, port=0, stream_config=object())


def test_video_functions_refuse():
    from rtseg_tpu_torch.serve import loadgen
    for fn in (loadgen.synth_video, loadgen.make_video_payloads,
               loadgen.bench_video, loadgen.check_video_report,
               loadgen.format_video_report):
        with pytest.raises(NotImplementedError, match='"The planes"'):
            fn()


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, str(ROOT / 'tools' / 'torch_segserve.py'), 'bench',
         '--device', 'cpu', '--compute_dtype', 'float32', '--model',
         'fastscnn', '--num_class', '5', '--colormap', 'custom',
         '--buckets', '32x32,48x48', '--batch', '4', *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_cli_bench_check_passes_on_the_cpu(tmp_path):
    report_path = tmp_path / 'report.json'
    proc = _cli('--requests', '16', '--rps', '40', '--check', '--via-http',
                '--p95-ms', '30000', '--report-json', str(report_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'torch_segserve check OK: 16/16 ok' in proc.stdout
    report = json.loads(report_path.read_text())
    assert report['engine']['executables'] == 2
    assert report['device'] == 'cpu' and report['mode'] == 'http'
    proc = _cli('--requests', '4', '--rps', '40', '--check',
                '--p95-ms', '0.000001')
    assert proc.returncode == 1 and 'check FAILED' in proc.stderr
    proc = _cli('--requests', '4', '--bundle', 'dir')
    assert proc.returncode != 0 and '"The planes"' in proc.stderr
    # --compile-cache is taken: the run passes with the cache under it
    cache = tmp_path / 'cache'
    proc = _cli('--requests', '4', '--rps', '40', '--check',
                '--p95-ms', '30000', '--compile-cache', str(cache))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (cache / 'exe').is_dir()
