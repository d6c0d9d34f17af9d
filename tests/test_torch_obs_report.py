"""The port's run reports, trace assembly and live poller
(rtseg_tpu_torch/obs/report.py, trail.py, live.py) against the JAX
package's on the same inputs.

Event streams, sink directories and Prometheus texts are made from numpy
seeds and go through both packages' functions; the outputs must be equal,
floats within 1e-12 relative, and the formatted texts (format_summary,
diff_table, format_timeline, format_frame) equal character for character.
The live poller's clocks (time.time, time.monotonic) are scripted so two
pollers see the same instants."""

import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from rtseg_tpu.obs import live as jlive
from rtseg_tpu.obs import report as jreport
from rtseg_tpu.obs import trail as jtrail
from rtseg_tpu.obs.metrics import MetricsRegistry as JRegistry
from rtseg_tpu.obs.metrics import render_prometheus as jrender
from rtseg_tpu_torch.obs import live as tlive
from rtseg_tpu_torch.obs import report as treport
from rtseg_tpu_torch.obs import trail as ttrail
from rtseg_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from rtseg_tpu_torch.obs.metrics import render_prometheus as trender

REL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(a, b, path='$'):
    """Equal structures; floats within REL relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert a == pytest.approx(b, rel=REL, abs=0.0), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------------ events
def _profile_event(rng, source='sampled'):
    cats = {c: float(rng.uniform(0.1, 9)) for c in
            ('conv', 'matmul', 'copy', 'elementwise', 'batch_norm',
             'resize_argmax', 'collective')}
    if rng.random() < 0.5:
        cats['unattributed'] = float(rng.uniform(0, 0.5))
    busy = sum(cats.values())
    window = busy * float(rng.uniform(1.05, 1.6))
    ev = {'event': 'profile', 'window_ms': window, 'device_busy_ms': busy,
          'idle_ms': window - busy, 'busy_frac': busy / window,
          'attributed_frac': 1 - cats.get('unattributed', 0) / busy,
          'n_ops': int(rng.integers(10, 900)), 'device_track': True,
          'categories': cats,
          'modules': {f'mod{i}/sub': float(rng.uniform(0, 3))
                      for i in range(4)},
          'top_ops': [['conv_kernel', 1.0]], 'source': source}
    if source == 'sampled':
        iters = int(rng.integers(1, 4))
        ev.update(iters=iters, ms_per_iter=busy / iters,
                  retraced=bool(rng.random() < 0.2),
                  wall_ms=window * 1.1)
    return ev


def run_events(seed: int, hosts: int = 1, crashed: bool = False,
               serving: bool = False, streaming: bool = False,
               resumes: int = 0):
    """One run's events across `hosts`, seeded: steps (the first flagged
    compile), epochs, spans, cache, memory, profile and stall events and,
    as asked, serving, streaming, rollout, flight and compile events."""
    rng = np.random.default_rng(seed)
    out = []
    t = 1.7e9 + seed

    def emit(host, **ev):
        nonlocal t
        t += float(rng.uniform(0.001, 0.2))
        ev.setdefault('ts', t)
        ev['host'] = host
        out.append(ev)

    for host in range(hosts):
        for r in range(resumes + 1):
            emit(host, event='run_start', model='bisenetv2',
                 dataset='synthetic', total_epoch=2, global_train_bs=16,
                 devices=hosts, attempt=r)
        for epoch in range(2):
            for kind, n in (('train', 6), ('val', 3)):
                for i in range(n):
                    ev = dict(event='step', kind=kind, seq=i + 1,
                              dur_s=float(rng.uniform(0.01, 0.3)),
                              data_wait_s=float(rng.uniform(0, 0.05)),
                              imgs=16, epoch=epoch)
                    if kind == 'train':
                        ev['step'] = epoch * n + i + 1
                    if i == 0 and (epoch == 0 or kind == 'val'
                                   and rng.random() < 0.5):
                        ev['compile'] = True
                    emit(host, **ev)
                emit(host, event='epoch', epoch=epoch, kind=kind, steps=n,
                     mean_loss=float(rng.uniform(0.5, 2)),
                     data_wait_s=0.1, step_s=0.9)
            emit(host, event='span', name='data/h2d',
                 dur_s=float(rng.uniform(0, 0.01)), depth=0)
            emit(host, event='span', name='val/readback',
                 dur_s=float(rng.uniform(0, 0.01)), depth=1)
            emit(host, event='cache', cached=bool(rng.random() < 0.8),
                 hits=int(rng.integers(0, 50)),
                 misses=int(rng.integers(0, 5)))
            emit(host, event='memory', device='cuda:0',
                 bytes_in_use=int(rng.integers(1, 9)) << 30,
                 peak_bytes_in_use=int(rng.integers(9, 20)) << 30,
                 bytes_limit=80 << 30,
                 largest_alloc_size=int(rng.integers(1, 3)) << 30)
            for _ in range(2):
                emit(host, **_profile_event(rng))
        emit(host, **_profile_event(rng, source='debug'))
        emit(host, event='compile', dur_s=float(rng.uniform(1, 9)),
             cache_hit=bool(rng.random() < 0.5))
        if rng.random() < 0.7:
            emit(host, event='stall', step=3, elapsed_s=5.0,
                 deadline_s=2.0, stacks='--- thread', trace_dir=None,
                 top_device_ops=[{'name': 'nccl', 'ms': 1.0}])
        if serving:
            for k in range(40):
                status = rng.choice(['ok', 'ok', 'ok', 'dropped',
                                     'rejected'])
                ev = dict(event='request', status=str(status),
                          e2e_ms=float(rng.uniform(5, 90)),
                          queue_ms=float(rng.uniform(0, 9)),
                          device_ms=float(rng.uniform(1, 30)),
                          post_ms=float(rng.uniform(0, 3)),
                          trace_id=f'{k:016x}')
                if k % 3:
                    ev['decode_ms'] = float(rng.uniform(0, 4))
                emit(host, **ev)
                if k % 4 == 0:
                    emit(host, event='batch', size=int(rng.integers(1, 9)),
                         cap=8, traces=[f'{k:016x}'])
            emit(host, event='rollout', action='promote', version='v2',
                 reason='healthy')
            emit(host, event='flight_dump', reason='slo_breach',
                 records=12, source='replica', path='/x/flight-1.jsonl',
                 traffic_mix={'512x1024': 0.5})
        if streaming:
            for k in range(30):
                emit(host, event='frame', session=f's{k % 3}', seq=k,
                     status=str(rng.choice(['ok', 'ok', 'dropped_late',
                                            'stale'])),
                     e2e_ms=float(rng.uniform(10, 60)),
                     mask_age=int(rng.integers(0, 3)),
                     provenance=str(rng.choice(['keyframe', 'reuse'])))
            emit(host, event='session', action='open', session='s0')
            emit(host, event='session_migrate', session='s1')
        if not crashed:
            emit(host, event='run_end', wall_s=float(rng.uniform(5, 20)))
    return out


CASES = {
    'train': dict(seed=1),
    'two_hosts': dict(seed=2, hosts=2),
    'crashed': dict(seed=3, crashed=True),
    'serving': dict(seed=4, serving=True),
    'streaming': dict(seed=5, streaming=True, serving=True),
    'resumed': dict(seed=6, resumes=2),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_summarize_and_format_match_jax(case):
    events = run_events(**CASES[case])
    roofline = {'bisenetv2': {'model': 'bisenetv2', 'ceiling_frac': 0.41,
                              'int8_ceiling_frac': 0.62}}
    for rl in (None, roofline):
        a = treport.summarize(events, roofline=rl)
        b = jreport.summarize(events, roofline=rl)
        assert_same(a, b)
        assert treport.format_summary(a, 'run/segscope') == \
            jreport.format_summary(b, 'run/segscope')


def test_diff_rows_and_table_match_jax():
    for sa, sb in (('train', 'serving'), ('serving', 'streaming'),
                   ('crashed', 'two_hosts')):
        ea, eb = run_events(**CASES[sa]), run_events(**CASES[sb])
        a, b = treport.summarize(ea), treport.summarize(eb)
        rows = treport.diff_rows(a, b)
        assert_same(rows, jreport.diff_rows(a, b))
        assert treport.diff_table(a, b, rows=rows) == \
            jreport.diff_table(a, b, rows=rows)
        assert treport.diff_table(a, b) == jreport.diff_table(a, b)


def _write_stream(path, events, torn=True):
    with open(path, 'w') as f:
        for e in events:
            f.write(json.dumps(e) + '\n')
        if torn:
            f.write('{"event": "step", "kind": "tr')     # a killed writer


def test_load_events_and_roofline_match_jax(tmp_path):
    events = run_events(seed=7, hosts=2, resumes=1)
    for host in (0, 1):
        _write_stream(tmp_path / f'events-{host:03d}.jsonl',
                      [e for e in events if e['host'] == host])
    for last in (True, False):
        a = treport.load_events(str(tmp_path), last_run=last)
        assert_same(a, jreport.load_events(str(tmp_path), last_run=last))
        one = str(tmp_path / 'events-001.jsonl')
        assert_same(treport.load_events(one, last_run=last),
                    jreport.load_events(one, last_run=last))
    assert_same(treport.summarize(treport.load_events(str(tmp_path))),
                jreport.summarize(jreport.load_events(str(tmp_path))))
    with pytest.raises(FileNotFoundError):
        treport.load_events(str(tmp_path / 'nowhere'))
    rl = tmp_path / 'roofline.jsonl'
    rl.write_text('\n'.join([
        json.dumps({'model': 'bisenetv2', 'ceiling_frac': 0.4}),
        json.dumps({'model': 'enet', 'error': 'no cost analysis'}),
        'not json', '',
        json.dumps({'model': 'ddrnet', 'ceiling_frac': 0.3})]))
    assert_same(treport.load_roofline(str(rl)),
                jreport.load_roofline(str(rl)))


# ------------------------------------------------------------------- trail
def _sink_tree(root, seed):
    """A router sink with hop events and two replicas' sinks with
    ingress, batch and request events and a flight snapshot, seeded;
    the trace ids they carry."""
    rng = np.random.default_rng(seed)
    ids = [f'{int(x):016x}' for x in rng.integers(1, 2 ** 62, 6)]
    (root / 'replica-0').mkdir(parents=True)
    (root / 'replica-1').mkdir()
    router, reps = [], {0: [], 1: []}
    flights = []
    t = 1.7e9
    for k, tid in enumerate(ids):
        t += 0.01
        rep = k % 2
        req = {'event': 'request', 'trace_id': tid, 'ts': t + 0.002,
               'status': 'ok', 'e2e_ms': float(rng.uniform(10, 40)),
               'queue_ms': float(rng.uniform(0, 4)),
               'assemble_ms': float(rng.uniform(0, 2)),
               'device_ms': float(rng.uniform(3, 20)),
               'post_ms': float(rng.uniform(0, 2)),
               'decode_ms': float(rng.uniform(0, 3)), 'bucket': '64x64'}
        if k not in (2, 3):
            router.append({'event': 'hop', 'trace_id': tid, 'ts': t,
                           'e2e_ms': req['e2e_ms'] + 9,
                           'upstream_ms': req['e2e_ms'] + 2,
                           'status': 'ok', 'group': 'g', 'version': 'v1',
                           'replica': f'replica-{rep}', 'attempts': 1})
        reps[rep].append({'event': 'ingress', 'trace_id': tid,
                          'ts': t + 0.001, 'bucket': '64x64'})
        reps[rep].append({'event': 'batch', 'traces': [tid, ids[0]],
                          'ts': t + 0.0015, 'size': 2, 'wait_ms': 1.5})
        if k != 4:
            reps[rep].append(req)
        else:
            flights.append(dict(req, event=None))
        if k == 3:
            reps[rep].append({'event': 'frame', 'trace_id': tid,
                              'ts': t + 0.003, 'status': 'ok',
                              'e2e_ms': req['e2e_ms'] + 5, 'session': 's',
                              'seq': 7, 'provenance': 'keyframe'})
    _write_stream(root / 'events-000.jsonl', router)
    for rep, evs in reps.items():
        _write_stream(root / f'replica-{rep}' / 'events-000.jsonl', evs)
    with open(root / 'replica-0' / 'flight-replica-1.jsonl', 'w') as f:
        for e in flights:
            e = {k: v for k, v in e.items() if k != 'event'}
            f.write(json.dumps(e) + '\n')
    return ids + ['ffffffffffffffff']


def test_trail_assembly_matches_jax(tmp_path):
    ids = _sink_tree(tmp_path, seed=11)
    dirs = [str(tmp_path)]
    assert ttrail.find_sink_files(dirs) == jtrail.find_sink_files(dirs)
    anchors = set()
    for tid in ids:
        a, b = ttrail.load_trace(dirs, tid), jtrail.load_trace(dirs, tid)
        assert_same(a, b)
        ta, tb = ttrail.assemble(a, tid), jtrail.assemble(b, tid)
        assert_same(ta, tb)
        assert_same(ttrail.assemble_trace(dirs, tid),
                    jtrail.assemble_trace(dirs, tid))
        if ta is not None:
            anchors.add(ta['anchor'])
            assert ttrail.format_timeline(ta) == jtrail.format_timeline(tb)
            assert sum(r['ms'] for r in ta['rows']) == pytest.approx(
                ta['e2e_ms'], abs=1e-6)
    assert anchors == {'router', 'replica', 'stream'}


# -------------------------------------------------------------------- live
def _registries(seed):
    """The same seeded traffic into a JAX and a port MetricsRegistry."""
    rng = np.random.default_rng(seed)
    regs = (JRegistry(), TRegistry())
    draws = [(str(rng.choice(['ok', 'ok', 'ok', 'rejected', 'error'])),
              float(rng.uniform(1, 300)),
              f'{int(rng.integers(1, 2 ** 62)):016x}') for _ in range(60)]
    step_ms = rng.uniform(50, 90, 11)
    for reg in regs:
        h = reg.histogram('serve_request_e2e_ms', help='e2e')
        for status, ms, tid in draws:
            reg.counter('serve_requests_total', help='requests',
                        status=status).inc()
            if status == 'ok':
                h.observe(ms, exemplar={'trace_id': tid})
        reg.gauge('serve_queue_depth', help='q').set(3)
        reg.counter('serve_batched_requests_total', help='b').inc(40)
        reg.counter('serve_padded_slots_total', help='p').inc(8)
        reg.counter('train_steps_total', help='s', kind='train').inc(12)
        reg.counter('train_compile_steps_total', help='c',
                    kind='train').inc(1)
        reg.counter('train_imgs_total', help='i', kind='train').inc(192)
        th = reg.histogram('train_step_ms', help='t', kind='train')
        for ms in step_ms:
            th.observe(float(ms))
        reg.gauge('train_data_wait_frac', help='w', kind='train').set(0.25)
        reg.gauge('train_goodput', help='g', kind='train').set(0.5)
        reg.gauge('device_busy_frac', help='b').set(0.75)
        reg.gauge('device_memory_bytes', help='m',
                  kind='peak_bytes_in_use').set(5 << 30)
        reg.counter('profile_captures_total', help='c').inc(2)
    return regs


def test_prometheus_parsers_match_jax():
    for seed in (1, 2):
        jreg, treg = _registries(seed)
        for text in (jrender(jreg), trender(treg)):
            assert_same(tlive.parse_prometheus(text),
                        jlive.parse_prometheus(text))
            assert_same(tlive.parse_exemplars(text),
                        jlive.parse_exemplars(text))
        # the two packages' registries render the same text
        assert trender(treg) == jrender(jreg)


class _Clock:
    def __init__(self, t0):
        self.t = t0

    def __call__(self):
        return self.t


@pytest.fixture
def metrics_server():
    """A localhost server whose /metrics serves `state['text']` and
    whose POST /debug/flight echoes the reason."""
    state = {'text': ''}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = state['text'].encode()
            self.send_response(200)
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            body = json.loads(self.rfile.read(n) or b'{}')
            data = json.dumps({'records': 3, 'source': 'replica',
                               'reason': body.get('reason')}).encode()
            self.send_response(200)
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(('127.0.0.1', 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f'http://127.0.0.1:{srv.server_address[1]}', state
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=5)


def test_metrics_poller_frames_and_checks_match_jax(metrics_server,
                                                    monkeypatch):
    url, state = metrics_server
    clock = _Clock(100.0)
    monkeypatch.setattr('time.monotonic', clock)
    pollers = (tlive.MetricsPoller(url), jlive.MetricsPoller(url))
    for seed in (1, 2, 3):
        state['text'] = jrender(_registries(seed)[0])
        clock.t += 1.5
        a, b = (p.poll() for p in pollers)
        assert_same(a, b)
        assert tlive.format_frame(a) == jlive.format_frame(b)
        for kw in ({}, {'p99_ms': 100.0}, {'max_hbm_bytes': 1 << 30}):
            assert tlive.check_frame(a, **kw) == jlive.check_frame(b, **kw)
    assert tlive.scrape_counter_sum(url, 'serve_requests_total',
                                    status='ok') == \
        jlive.scrape_counter_sum(url, 'serve_requests_total', status='ok')
    assert tlive.trigger_flight(url, reason='slo') == \
        jlive.trigger_flight(url, reason='slo')


def test_sink_tailer_frames_match_jax(tmp_path, monkeypatch):
    events = run_events(seed=8, serving=True, streaming=True)
    clock = _Clock(events[0]['ts'])
    monkeypatch.setattr('time.time', clock)
    path = tmp_path / 'events-000.jsonl'
    tailers = (tlive.SinkTailer(str(tmp_path), window_s=5.0),
               jlive.SinkTailer(str(tmp_path), window_s=5.0))
    open(path, 'w').close()
    for lo in range(0, len(events), 37):
        with open(path, 'a') as f:
            for e in events[lo:lo + 37]:
                f.write(json.dumps(e) + '\n')
            f.write('{"event": "req')            # a torn tail, then more
        clock.t = events[min(lo + 36, len(events) - 1)]['ts'] + 0.5
        a, b = (t.poll() for t in tailers)
        assert_same(a, b)
        assert tlive.format_frame(a) == jlive.format_frame(b)
        for kw in ({}, {'p99_ms': 30.0}, {'max_hbm_bytes': 1 << 33}):
            assert tlive.check_frame(a, **kw) == jlive.check_frame(b, **kw)
        with open(path, 'rb+') as f:             # drop the torn tail
            f.seek(-len(b'{"event": "req'), os.SEEK_END)
            f.truncate()


def test_segscope_cli_report_diff_trace(tmp_path):
    """tools/torch_segscope.py's report, diff and trace on seeded runs:
    the JAX tool's exit codes and texts."""
    import subprocess
    import sys
    for name, case in (('a', 'train'), ('b', 'serving')):
        (tmp_path / name).mkdir()
        _write_stream(tmp_path / name / 'events-000.jsonl',
                      run_events(**CASES[case]), torn=False)
    ids = _sink_tree(tmp_path / 'fleet', seed=12)

    runs = [('report', str(tmp_path / 'a')),
            ('report', str(tmp_path / 'a'), '--json'),
            ('report', str(tmp_path / 'b'), '--check'),
            ('diff', str(tmp_path / 'a'), str(tmp_path / 'b')),
            ('trace', ids[0], str(tmp_path / 'fleet')),
            ('trace', 'ffffffffffffffff', str(tmp_path / 'fleet')),
            ('report', str(tmp_path / 'nowhere'))]
    # every run of both tools at once: each process's time is its imports
    procs = {(args, tool): subprocess.Popen(
                 [sys.executable, os.path.join(ROOT, 'tools', tool), *args],
                 stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                 text=True)
             for args in runs
             for tool in ('torch_segscope.py', 'segscope.py')}
    got = {}
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=120)
        got[key] = (proc.returncode, out)
    codes = []
    for args in runs:
        mine, theirs = (got[args, t] for t in ('torch_segscope.py',
                                               'segscope.py'))
        assert mine == theirs, (args, mine, theirs)
        codes.append(mine[0])
    assert codes[:2] == [0, 0] and codes[2] in (0, 1)
    assert codes[3:] == [0, 0, 2, 2]
