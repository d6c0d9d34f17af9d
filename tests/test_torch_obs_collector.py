"""The port's step collector, stall watchdog, sink naming, memory events,
step signature counts and TensorBoard writer (rtseg_tpu_torch/obs/
collector.py, watchdog.py, core.py; train/step.py `_cache_size`;
utils/misc.py TBWriter) against the JAX package's.

Both packages' StepCollector and StallWatchdog are driven by the same
scripted clock (time.perf_counter, time.monotonic monkeypatched) and the
same seeded loop or stall; their events are compared key for key (the
wall-clock `ts` and the stack text aside), their watchdog beats, live
metrics and deadlines value for value."""

import json
import logging
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from rtseg_tpu.obs import collector as jcollector
from rtseg_tpu.obs import watchdog as jwatchdog
from rtseg_tpu.obs.core import EventSink as JSink
from rtseg_tpu.obs.live import parse_prometheus
from rtseg_tpu.obs.metrics import MetricsRegistry as JRegistry
from rtseg_tpu.obs.metrics import render_prometheus as jrender
from rtseg_tpu.utils.misc import TBWriter as JTBWriter
from rtseg_tpu_torch.config import SegConfig
from rtseg_tpu_torch.obs import collector as tcollector
from rtseg_tpu_torch.obs import core as tcore
from rtseg_tpu_torch.obs import profile as tprofile
from rtseg_tpu_torch.obs import watchdog as twatchdog
from rtseg_tpu_torch.obs.core import EventSink as TSink
from rtseg_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from rtseg_tpu_torch.obs.metrics import render_prometheus as trender
from rtseg_tpu_torch.utils.misc import TBWriter as TTBWriter

import _torch_ddp_worker as ddp


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The port's models here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Step:
    """A step whose `_cache_size()` the script sets."""

    def __init__(self):
        self.size = 0

    def _cache_size(self):
        return self.size


class _Watchdog:
    def __init__(self):
        self.beats = []

    def beat(self, dur_s=None, step=None):
        self.beats.append((dur_s, step))


def _events(path):
    out = []
    for line in open(path):
        e = json.loads(line)
        e.pop('ts')
        out.append(e)
    return out


def _script(seed, n=23):
    rng = np.random.default_rng(seed)
    waits = rng.uniform(0, 0.05, n).round(6)
    durs = rng.uniform(0.01, 0.3, n).round(6)
    # the signature count grows at the first step and at two later ones
    sizes = np.cumsum([1] + [int(rng.random() < 0.1) for _ in range(n - 1)])
    return waits, durs, sizes


def _drive(collector_cls, sink, registry, clock, script, epoch):
    waits, durs, sizes = script
    step, wd = _Step(), _Watchdog()
    col = collector_cls(sink, 'train', imgs_per_step=16, jitted=step,
                        watchdog=wd, epoch=epoch, registry=registry)

    def loader():
        for i in range(len(waits)):
            clock.t += float(waits[i])
            yield i

    intervals = []
    for i in col.wrap(loader()):
        clock.t += float(durs[i])
        step.size = int(sizes[i])
        col.end_step(step=i + 1 if i % 5 else None)
        if i % 4 == 3:
            intervals.append(col.interval_stats())
    col.end_step()                        # no open step: a no-op
    totals = (col.n_steps, col.total_dur, col.total_wait, col.compile_s,
              col.n_compile)
    return wd.beats, intervals, totals


@pytest.mark.parametrize('seed,epoch', [(1, 0), (2, 3), (3, None)])
def test_step_collector_matches_jax(tmp_path, monkeypatch, seed, epoch):
    clock = _Clock()
    monkeypatch.setattr(time, 'perf_counter', clock)
    script = _script(seed)
    out = {}
    for name, cls, sink_cls, reg_cls, render in (
            ('jax', jcollector.StepCollector, JSink, JRegistry, jrender),
            ('port', tcollector.StepCollector, TSink, TRegistry, trender)):
        clock.t = 1000.0
        sink = sink_cls(str(tmp_path / name / 'events-000.jsonl'))
        reg = reg_cls()
        res = _drive(cls, sink, reg, clock, script, epoch)
        sink.close()
        out[name] = (res, _events(sink.path),
                     parse_prometheus(render(reg)))
    (jres, jev, jmet), (tres, tev, tmet) = out['jax'], out['port']
    assert tres == jres
    assert tev == jev
    assert tmet == jmet
    assert sum(e.get('compile', False) for e in tev) == \
        len(set(script[2])) and tev[0]['compile'] is True


def _stall_script(wd_cls, sink_cls, path, clock, **kw):
    """Beats, then a missed beat past the deadline, a second poll (no
    second fire), a recovery and a stall before any step finished (the
    compile grace)."""
    sink = sink_cls(path)
    wd = wd_cls(sink, min_deadline_s=2.0, factor=4.0, poll_s=0.05, **kw)
    seen = [wd.deadline_s()]
    wd.beat()                                   # a batch arrived
    wd._poll_once()
    for k, dur in enumerate((0.5, 0.7, 0.6, 0.9, 0.8)):
        clock.t += dur
        wd.beat(dur_s=dur, step=k + 1)
        seen.append(wd.deadline_s())
        wd._poll_once()
    clock.t += 3.5                              # 4 x median 0.7 = 2.8 s
    wd._poll_once()                             # fires
    clock.t += 10.0
    wd._poll_once()                             # once per missed beat
    wd.beat(dur_s=0.7, step=6)
    clock.t += 1.0
    wd._poll_once()
    seen.append((wd.stall_count, wd.poll_failures, wd.fire_errors))
    fresh = wd_cls(sink, min_deadline_s=1.0, factor=4.0,
                   compile_grace_s=30.0)
    fresh.beat()
    clock.t += 20.0
    fresh._poll_once()                          # inside the grace
    seen.append((fresh.deadline_s(), fresh.stall_count))
    sink.close()
    return seen


def test_stall_watchdog_matches_jax(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, 'monotonic', clock)
    got = {}
    for name, cls, sink_cls in (('jax', jwatchdog.StallWatchdog, JSink),
                                ('port', twatchdog.StallWatchdog, TSink)):
        clock.t = 1000.0
        path = str(tmp_path / name / 'events-000.jsonl')
        seen = _stall_script(cls, sink_cls, path, clock)
        events = _events(path)
        stacks = [e.pop('stacks') for e in events]
        got[name] = (seen, events, stacks)
    (jseen, jev, jstacks), (tseen, tev, tstacks) = got['jax'], got['port']
    assert tseen == jseen
    assert tev == jev
    assert [e['event'] for e in tev] == ['stall']
    assert tev[0]['elapsed_s'] == 3.5 and tev[0]['deadline_s'] == 2.8
    assert tev[0]['step'] == 5 and tev[0]['top_device_ops'] is None
    # every live thread's stack, this one's included
    for text in tstacks:
        assert f'(id {threading.get_ident()})' in text
        assert '_stall_script' in text


def test_dump_all_stacks_names_every_thread():
    ev = threading.Event()
    th = threading.Thread(target=ev.wait, name='parked-worker',
                          daemon=True)
    th.start()
    try:
        port, jax_ = twatchdog.dump_all_stacks(), jwatchdog.dump_all_stacks()
    finally:
        ev.set()
        th.join(timeout=5)
    for text in (port, jax_):
        assert '--- thread parked-worker' in text
        assert '--- thread MainThread' in text


def test_watchdog_thread_fires_once_with_a_capture(tmp_path):
    """The real thread on a real stall: one stall event with every
    thread's stack and the capture window's top device ops (a list; on
    the CPU the window started on the watchdog's thread records none of
    this thread's ops), a trace kept under trace_dir, the flight
    recorders dumped; and with the capture lock held, the event comes
    without ops and the failed capture is counted."""
    from rtseg_tpu_torch.obs.flight import FlightRecorder
    sink = TSink(str(tmp_path / 'events-000.jsonl'))
    rec = FlightRecorder(capacity=4, source='stall-test')
    rec.record({'trace_id': 'a' * 16, 'status': 'ok'})
    tcore.set_sink(sink)
    trace_dir = str(tmp_path / 'stall_trace')
    wd = twatchdog.StallWatchdog(sink, min_deadline_s=0.3, poll_s=0.05,
                                 trace_dir=trace_dir, trace_len_s=0.1,
                                 logger=logging.getLogger('stall-test'))
    wd.start()
    try:
        wd.beat(dur_s=0.01, step=1)
        deadline = time.monotonic() + 10
        while wd.stall_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)                         # the capture, then idle
        first = wd.stall_count
        # a second stall while another capture holds the profiler
        with tprofile._CAPTURE_LOCK:
            wd.beat(dur_s=0.01, step=2)
            deadline = time.monotonic() + 10
            while wd.stall_count == first and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.2)
    finally:
        wd.stop()
        tcore.set_sink(None)
    sink.close()
    assert first == 1 and wd.stall_count == 2
    assert wd.fire_errors == 1 and wd.poll_failures == 0
    events = [json.loads(line) for line in open(sink.path)]
    stalls = [e for e in events if e['event'] == 'stall']
    assert [e['step'] for e in stalls] == [1, 2]
    assert isinstance(stalls[0]['top_device_ops'], list)
    assert stalls[0]['trace_dir'] == trace_dir
    assert tprofile._trace_files(trace_dir)
    assert stalls[1]['top_device_ops'] is None
    assert stalls[1]['trace_dir'] is None
    for e in stalls:
        assert 'segscope-watchdog' in e['stacks']
        assert 'MainThread' in e['stacks']
    dumps = [e for e in events if e['event'] == 'flight_dump'
             and e['source'] == 'stall-test']
    assert [d['reason'] for d in dumps] == ['stall', 'stall']
    assert all(d['records'] == 1 for d in dumps)
    del rec


def test_stall_event_names_its_ops_unknown_when_the_trace_lost_some(
        tmp_path, monkeypatch):
    """A stall capture whose trace lost launches' device work (a capture
    from the watchdog's thread late in a process, on the card) gives
    top_device_ops None beside lost_launches, not the ops it kept; a
    complete one gives its ops and no lost_launches."""
    sink = TSink(str(tmp_path / 'events-000.jsonl'))
    got = []
    monkeypatch.setattr(tprofile, 'capture_window',
                        lambda s, trace_dir=None: got.pop(0))
    wd = twatchdog.StallWatchdog(sink, trace_dir=str(tmp_path / 't'))
    for lost in (7, 0):
        got.append(tprofile.DeviceProfile(n_ops=2, device_track=True,
                                          top_ops=[('sleep', 300e3)],
                                          lost_launches=lost))
        wd._fire(3.0, 2.0, step=4)
    sink.close()
    stalls = [json.loads(line) for line in open(sink.path)
              if json.loads(line)['event'] == 'stall']
    assert stalls[0]['top_device_ops'] is None
    assert stalls[0]['lost_launches'] == 7
    assert stalls[1]['top_device_ops'] == [{'name': 'sleep', 'ms': 300.0}]
    assert 'lost_launches' not in stalls[1]
    assert wd.stall_count == 2 and wd.fire_errors == 0


def test_init_run_names_the_file_by_rank(tmp_path):
    """Two gloo ranks write events-000.jsonl and events-001.jsonl, each
    its own; one process without a group writes events-000.jsonl."""
    obs_dir = str(tmp_path / 'segscope')
    got = ddp.run('obs_sink', 2, tmp_path, obs_dir=obs_dir, timeout=120)
    assert [os.path.basename(g['path']) for g in got] == [
        'events-000.jsonl', 'events-001.jsonl']
    for rank in (0, 1):
        events = [json.loads(line) for line in
                  open(os.path.join(obs_dir, f'events-{rank:03d}.jsonl'))]
        assert [e['event'] for e in events] == ['run_start', 'probe']
        assert all(e['host'] == rank for e in events)
        assert events[0]['rank'] == rank
    sink = tcore.init_run(str(tmp_path / 'one'), meta={'model': 'x'})
    sink.close()
    assert os.path.basename(sink.path) == 'events-000.jsonl'
    assert json.loads(open(sink.path).readline())['host'] == 0


def test_emit_memory_keys_and_no_cuda(tmp_path, monkeypatch):
    """Without CUDA no memory event, as JAX's CPU backend writes none;
    with the card's statistics (faked here) one event under the JAX
    package's keys, largest_alloc_size the largest segment."""
    sink = TSink(str(tmp_path / 'events-000.jsonl'))
    tcore.emit_memory(sink)
    tcore.emit_memory(None)
    assert open(sink.path).read() == ''
    monkeypatch.setattr(tcore, '_card', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'memory_stats', lambda card: {
        'allocated_bytes.all.current': 5 << 30,
        'allocated_bytes.all.peak': 9 << 30,
        'reserved_bytes.all.current': 10 << 30})

    class _Props:
        total_memory = 80 << 30
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda card: _Props())
    monkeypatch.setattr(torch.cuda, 'memory_snapshot', lambda: [
        {'device': 0, 'total_size': 2 << 20},
        {'device': 0, 'total_size': 3 << 30},
        {'device': 1, 'total_size': 7 << 30}])
    tcore.emit_memory(sink)
    sink.close()
    (ev,) = [json.loads(line) for line in open(sink.path)]
    ev.pop('ts')
    assert ev == {'event': 'memory', 'device': 'cuda:0',
                  'bytes_in_use': 5 << 30, 'peak_bytes_in_use': 9 << 30,
                  'bytes_limit': 80 << 30, 'largest_alloc_size': 3 << 30}
    # the keys the JAX package's memory event carries on a TPU
    from rtseg_tpu.obs.core import _MEMORY_KEYS
    assert set(ev) - {'event', 'device'} == set(_MEMORY_KEYS)


def test_steps_count_their_input_signatures():
    """build_train_step / build_eval_step / build_predict_step carry
    `_cache_size()`: the distinct (shape, dtype, device) signatures they
    were called with, which the collector reads as the JAX jit cache."""
    from rtseg_tpu_torch.models.registry import get_model
    from rtseg_tpu_torch.train.optim import get_optimizer
    from rtseg_tpu_torch.train.state import TrainState, make_ema_model
    from rtseg_tpu_torch.train.step import (build_eval_step,
                                            build_predict_step,
                                            build_train_step)
    torch.manual_seed(0)
    cfg = SegConfig(model='fastscnn', num_class=3, dataset='synthetic',
                    compute_dtype='float32', train_bs=2, crop_size=32)
    cfg.resolve(num_devices=1)
    cfg.resolve_schedule(train_num=8)
    model = get_model(cfg, device='cpu').eval()
    state = TrainState(step=0, model=model,
                       optimizer=get_optimizer(cfg, model.parameters()),
                       ema_model=make_ema_model(model))
    train = build_train_step(cfg)
    ev = build_eval_step(cfg, state.ema_model, 'cpu')
    pred = build_predict_step(cfg, state.ema_model, 'cpu')
    assert tcore.cache_size(train) == tcore.cache_size(ev) == 0
    assert tcore.cache_size(object()) is None

    def batch(n, h):
        return (torch.rand(n, h, h, 3),
                torch.randint(0, 3, (n, h, h), dtype=torch.int32))
    for imgs, msks in (batch(2, 32), batch(2, 32), batch(1, 32)):
        train(state, imgs, msks)
        ev(imgs, msks)
        pred(imgs)
    assert [tcore.cache_size(f) for f in (train, ev, pred)] == [2, 2, 2]
    ev(*batch(2, 32)[:1], batch(2, 32)[1].long())     # another dtype
    assert tcore.cache_size(ev) == 3


def _tb_triples(log_dir):
    """(tag, step, value) of every scalar in the event files of log_dir,
    read from the TFRecord frames with TensorBoard's Event proto."""
    from tensorboard.compat.proto import event_pb2
    out = []
    for name in sorted(os.listdir(log_dir)):
        data = open(os.path.join(log_dir, name), 'rb').read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack('<Q', data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.append((v.tag, ev.step, v.simple_value))
    return out


def test_tb_writer_writes_the_jax_triples(tmp_path):
    """Given the same scalars, the port's and JAX's TBWriter write equal
    (tag, step, value) triples; off and on a rank other than the main one
    both write nothing."""
    rng = np.random.default_rng(0)
    scalars = [({'train/loss': float(rng.uniform(0, 3)),
                 'train/loss_kd': np.float32(rng.uniform(0, 1))}, s)
               for s in range(1, 6)]
    iou = rng.uniform(0, 1, 4)
    got = {}
    for name, cls in (('jax', JTBWriter), ('port', TTBWriter)):
        cfg = SegConfig(save_dir=str(tmp_path / name))
        cfg.resolve()
        w = cls(cfg, True)
        for sc, step in scalars:
            w.add_scalars(sc, step)
        w.add_scalar('val/mIoU', float(iou.mean()), 3)
        w.add_scalars({f'val/IoU_cls{i:02d}': iou[i] for i in range(4)}, 3)
        w.close()
        got[name] = _tb_triples(cfg.tb_log_dir)
        for off in (cls(SegConfig(save_dir=str(tmp_path / 'off'),
                                  use_tb=False), True),
                    cls(cfg, False)):
            off.add_scalar('x', 1.0, 1)
            off.close()
    assert got['port'] == got['jax'] and len(got['port']) == 15
    assert not (tmp_path / 'off').exists()


def test_tb_writer_without_tensorboard_warns_once(tmp_path, monkeypatch,
                                                  caplog):
    """A machine without the tensorboard package: one warning that names
    it, then no TB files and no error (the JAX class goes silent)."""
    import builtins
    real = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith('torch.utils.tensorboard'):
            raise ImportError('No module named tensorboard')
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, '__import__', no_tb)
    cfg = SegConfig(save_dir=str(tmp_path), logger_name='tb-test')
    cfg.resolve()
    with caplog.at_level(logging.WARNING, logger='tb-test'):
        w = TTBWriter(cfg, True)
    w.add_scalars({'train/loss': 1.0}, 1)
    w.close()
    warnings = [r for r in caplog.records if 'tensorboard' in r.message]
    assert len(warnings) == 1 and not w.active
    assert not os.path.exists(cfg.tb_log_dir)


def test_trainer_reads_no_tb_scalars_back_without_a_writer(
        tmp_path, monkeypatch):
    """use_tb on a machine without tensorboard: the trainer decides once,
    when it opens its planes, that no rank writes TB files, and its train
    loop buffers and reads back no TB scalars; with the package it does,
    once a log interval."""
    import builtins
    from rtseg_tpu_torch.train import SegTrainer
    real = builtins.__import__
    flushed = []
    cfg = SegConfig(dataset='synthetic', model='fastscnn', num_class=5,
                    crop_size=32, train_bs=4, val_bs=4, synthetic_len=4,
                    total_epoch=1, compute_dtype='float32', base_workers=0,
                    log_interval=1, load_ckpt=False, save_ckpt=False,
                    use_obs=False, save_dir=str(tmp_path))
    cfg.resolve()
    trainer = SegTrainer(cfg, device='cpu')
    flush = trainer._flush_tb
    monkeypatch.setattr(trainer, '_flush_tb', lambda buf: (
        flushed.append(len(buf)), flush(buf)))

    def no_tb(name, *a, **k):
        if name.startswith('torch.utils.tensorboard'):
            raise ImportError('No module named tensorboard')
        return real(name, *a, **k)
    for missing, want in ((True, [0]), (False, [1, 0])):
        flushed.clear()
        if missing:
            monkeypatch.setattr(builtins, '__import__', no_tb)
        else:
            monkeypatch.setattr(builtins, '__import__', real)
        trainer._open_planes()
        try:
            assert trainer._tb_live is not missing
            trainer.train_one_epoch()
        finally:
            trainer._close_planes(0.0)
        assert flushed == want
        assert trainer._tb_live is False


class _StallingLoader:
    """A train loader whose batch `at` comes `sleep_s` late, once; the
    batches are fetched ahead of the steps, so the sleep starts once
    `steps()` reaches `at`."""

    def __init__(self, loader, at, sleep_s, steps):
        self.loader, self.at, self.sleep_s = loader, at, sleep_s
        self.steps = steps
        self.done = False

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.at and not self.done:
                self.done = True
                while self.steps() < self.at:
                    time.sleep(0.005)
                time.sleep(self.sleep_s)
            yield batch


def test_trainer_run_reports_a_seeded_stall(tmp_path):
    """SegTrainer.run() with the watchdog at a short deadline and a
    loader that sleeps past it once: one `stall` event, after step 2 (the
    last beat's), with every thread's stack (the sleeping loader's among
    them) and the window's ops; the report counts it and `report --check`
    fails on it."""
    import subprocess
    import sys
    from rtseg_tpu_torch.train import SegTrainer
    cfg = SegConfig(dataset='synthetic', model='fastscnn', num_class=5,
                    crop_size=32, train_bs=4, val_bs=4, synthetic_len=24,
                    total_epoch=1, compute_dtype='float32', base_workers=0,
                    log_interval=0, load_ckpt=False, save_ckpt=False,
                    use_tb=False, watchdog_min_s=1.5, watchdog_factor=5.0,
                    save_dir=str(tmp_path))
    cfg.resolve()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = SegTrainer(cfg, device='cpu')
        trainer.train_loader = _StallingLoader(trainer.train_loader, 2, 4.0,
                                               lambda: trainer.state.step)
        trainer.run()
    finally:
        torch.set_num_threads(n)
    assert not any(t.name == 'segscope-watchdog'
                   for t in threading.enumerate())
    obs_dir = tmp_path / 'segscope'
    events = [json.loads(line) for line in open(obs_dir / 'events-000.jsonl')]
    stalls = [e for e in events if e['event'] == 'stall']
    assert len(stalls) == 1, stalls
    (st,) = stalls
    assert st['step'] == 2 and st['elapsed_s'] > st['deadline_s'] >= 1.5
    assert 'in __iter__' in st['stacks'] and 'time.sleep' in st['stacks']
    assert isinstance(st['top_device_ops'], list)
    assert st['trace_dir'] == str(obs_dir / 'stall_trace')
    assert [e['kind'] for e in events if e['event'] == 'step'].count(
        'train') == 6
    from rtseg_tpu_torch.obs.report import load_events, summarize
    assert summarize(load_events(str(obs_dir)))['stalls'] == 1
    r = subprocess.run([sys.executable, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'tools', 'torch_segscope.py'), 'report', str(obs_dir), '--check'],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and 'stalls=1' in r.stderr
