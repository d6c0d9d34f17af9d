"""Device-time attribution over torch.profiler traces
(rtseg_tpu_torch/obs/profile.py) and its capture surfaces.

The parser runs on a golden trace written by tests/make_torch_prof_fixture.py
(kernels, launches, module ranges and autograd's sequence numbers made by
hand, with hand-computed totals): conv before gemm, K1's and K2's
buckets, the backward joined to its forward module by `Sequence number`,
launches found by `correlation`. Its `profile` event has the keys of the
JAX package's on the JAX golden fixture, and either package's report
reads the other's profile events. On the CPU, a trace captured in the test
goes through the CPU fallback (the outermost op events) with the module
ranges and the backward join on a real autograd graph."""

import gzip
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from rtseg_tpu.obs import profile as jprofile
from rtseg_tpu.obs import report as jreport
from rtseg_tpu_torch.obs import profile as tprofile
from rtseg_tpu_torch.obs import report as treport
from rtseg_tpu_torch.obs.core import EventSink
from rtseg_tpu_torch.obs.metrics import MetricsRegistry

import make_torch_prof_fixture as fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'torch_prof')
JAX_GOLDEN = os.path.join(ROOT, 'tests', 'data')


@pytest.mark.parametrize('name,cat,want', [
    # cuDNN's convolutions carry implicit_gemm: conv, checked before gemm
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_'
     'tilesize128x128x64_kernel__5x_cudnn', 'kernel', 'conv'),
    ('sm80_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_'
     'nchw_kernel', 'kernel', 'conv'),
    ('sm80_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw',
     'kernel', 'conv'),
    ('void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, '
     'false, false, true>(int, int, int, float const*, int, float*)',
     'kernel', 'conv'),
    ('void cutlass__5x_cudnn::Kernel<cutlass_tensorop_s1688fprop_optimized'
     '_tf32_64x64_16x10_nhwc_align4>(Params)', 'kernel', 'conv'),
    ('void at::native::(anonymous namespace)::conv_depthwise2d_forward_'
     'kernel<3, float, int>(float const*, float*)', 'kernel', 'conv'),
    ('nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT', 'kernel', 'matmul'),
    ('ampere_sgemm_128x64_nn', 'kernel', 'matmul'),
    ('void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16'
     '_16x16_128x2_tn_align8>(Params)', 'kernel', 'matmul'),
    ('ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage'
     '<4096ul>)', 'kernel', 'collective'),
    ('Memcpy DtoH (Device -> Pinned)', 'gpu_memcpy', 'copy'),
    ('Memset (Device)', 'gpu_memset', 'copy'),
    ('triton_red_fused_native_layer_norm_0', 'kernel', 'fusion'),
    # the port's two kernels, each in its own bucket
    ('void head_argmax_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, '
     'float const*, int*, float, HeadArgs)', 'kernel', 'resize_argmax'),
    ('confusion_kernel(int const*, int const*, int, long, int, int*)',
     'kernel', 'confusion_matrix'),
    # named bases, never a silent "unknown"
    ('void at::native::vectorized_elementwise_kernel<4, at::native::'
     'BinaryFunctor<float, float, float, at::native::binary_internal::'
     'MulFunctor<float> >, std::array<char*, 3ul> >(int)', 'kernel',
     'elementwise'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_'
     'impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator'
     'Base&)::{lambda()#3}>(at::TensorIteratorBase&)::{lambda(int)#1}>'
     '(int)', 'kernel', 'copy'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
     'at::native::MeanOps<float, float, float, float>, unsigned int, '
     'float, 4, 4> >(at::native::ReduceOp<float>)', 'kernel', 'reduce'),
    ('void at::native::batch_norm_collect_statistics_kernel<at::native::'
     'Var, float, float, float, int>(float)', 'kernel', 'batch_norm'),
    ('cudnn::bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float, 512, true, 1>',
     'kernel', 'batch_norm'),
    ('void at::native::(anonymous namespace)::upsample_bilinear2d_out_'
     'frame<float, float>(int, float)', 'kernel', 'upsample'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::'
     'native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 4, 128,'
     ' 1>(int)', 'kernel', 'cat'),
    ('void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, '
     'float, false, true, (cudnnKernelDataType_t)0>(float const*)',
     'kernel', 'layout'),
    ('void at::cuda::(anonymous namespace)::spin_kernel(long)', 'kernel',
     'spin'),
    # CPU op names (the CPU fallback)
    ('aten::conv2d', 'cpu_op', 'conv'),
    ('autograd::engine::evaluate_function: ConvolutionBackward0', 'cpu_op',
     'conv'),
    ('aten::addmm', 'cpu_op', 'matmul'),
    ('autograd::engine::evaluate_function: ClampMinBackward0', 'cpu_op',
     'clamp_min'),
    ('aten::convert_element_type', 'cpu_op', 'convert_element_type'),
    ('aten::copy_', 'cpu_op', 'copy'),
    ('c10d::allreduce_', 'cpu_op', 'collective'),
    ('%', 'kernel', 'unattributed'),
    ('', 'kernel', 'unattributed'),
])
def test_categorize(name, cat, want):
    assert tprofile.categorize(name, cat) == want


def test_parse_trace_golden_fixture():
    """The hand-made GPU trace: 16 device ops over a 470 us window, busy
    410 us (a side stream's 40 us copy lies under a kernel: the union),
    the six categories where they apply and K1, K2 in their own buckets;
    backward kernels on autograd's thread join their forward module by
    sequence number; a graph replay's kernel, a loss kernel outside any
    module, an ambiguous backward and one whose forward is not in the
    trace have no module."""
    p = tprofile.parse_trace(GOLDEN, depth=2)
    assert p.device_track and p.n_ops == 16
    assert p.window_us == 470.0 and p.busy_us == 410.0
    assert p.idle_us == 60.0 and p.busy_frac == pytest.approx(410 / 470)
    assert p.categories == {
        'conv': 190.0, 'matmul': 90.0, 'copy': 45.0, 'elementwise': 30.0,
        'collective': 30.0, 'resize_argmax': 20.0, 'reduce': 20.0,
        'confusion_matrix': 10.0, 'fusion': 10.0, 'unattributed': 5.0}
    assert p.attributed_frac == pytest.approx(1 - 5 / 410)
    assert p.modules == {'backbone/conv1': 190.0, 'backbone/gemm': 90.0,
                         'head': 40.0}
    assert tprofile.parse_trace(GOLDEN, depth=1).modules == {
        'backbone': 280.0, 'head': 40.0}
    assert p.top_ops[0][1] == 100.0 and 'fprop' in p.top_ops[0][0]
    ev = p.to_event(source='test')
    assert ev['event'] == 'profile' and ev['source'] == 'test'
    assert ev['device_busy_ms'] == 0.41 and ev['window_ms'] == 0.47
    assert list(ev['categories'])[:2] == ['conv', 'matmul']
    assert ev['modules'] == {'backbone/conv1': 0.19, 'backbone/gemm': 0.09,
                             'head': 0.04}


def test_fixture_is_what_its_script_writes(tmp_path):
    made = fixture.write(str(tmp_path / 'golden.pt.trace.json.gz'))
    assert open(made, 'rb').read() == open(
        os.path.join(GOLDEN, 'golden.pt.trace.json.gz'), 'rb').read()


def test_parse_trace_reads_plain_json_and_the_newest(tmp_path):
    with gzip.open(os.path.join(GOLDEN, 'golden.pt.trace.json.gz'),
                   'rt') as f:
        data = json.load(f)
    old = tmp_path / 'old.pt.trace.json'
    old.write_text(json.dumps({'traceEvents': []}))
    os.utime(old, (1, 1))
    (tmp_path / 'sub').mkdir()
    (tmp_path / 'sub' / 'run.pt.trace.json').write_text(json.dumps(data))
    (tmp_path / 'notes.json').write_text('{}')        # not a trace
    a, b = (tprofile.parse_trace(d, depth=2)
            for d in (str(tmp_path), GOLDEN))
    assert (a.categories, a.modules, a.busy_us) == (b.categories,
                                                    b.modules, b.busy_us)
    with pytest.raises(FileNotFoundError):
        tprofile.parse_trace(str(tmp_path / 'nope'))


def test_profile_event_keys_match_jax_and_reports_read_both():
    """The port's `profile` event has the JAX event's keys (each on its
    own golden fixture), and the port's and JAX's summarize give the same
    device section over a stream that holds both packages' events."""
    port = tprofile.parse_trace(GOLDEN).to_event(source='sampled', iters=1,
                                                 retraced=False)
    jax_ = jprofile.parse_trace(JAX_GOLDEN).to_event(source='sampled',
                                                     iters=1,
                                                     retraced=False)
    assert port.keys() == jax_.keys()
    assert tprofile.CATEGORIES == jprofile.CATEGORIES
    for ev in (port, jax_):
        ev['categories'] = {k: float(v) for k, v in
                            ev['categories'].items()}
    events = [{'event': 'run_start', 'ts': 1.0, 'host': 0,
               'model': 'bisenetv2'},
              dict(port, ts=2.0, host=0), dict(jax_, ts=3.0, host=0),
              {'event': 'memory', 'ts': 4.0, 'host': 0,
               'peak_bytes_in_use': 3 << 30, 'bytes_limit': 80 << 30},
              {'event': 'run_end', 'ts': 5.0, 'host': 0, 'wall_s': 4.0}]
    for evs in (events, events[:2] + events[3:], events[:1] + events[2:]):
        a, b = treport.summarize(evs), jreport.summarize(evs)
        assert a == b and a['device'] is not None
        assert treport.format_summary(a) == jreport.format_summary(b)
    assert treport.summarize(events)['profile_captures'] == 2
    assert treport.summarize(events)['dev_conv_ms'] > 0


def _launch(corr, name, ts, cat='cuda_runtime'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 1, 'tid': 2,
            'ts': ts, 'dur': 1, 'args': {'correlation': corr}}


def _work(corr, ts, cat='kernel'):
    return {'ph': 'X', 'cat': cat, 'name': f'k{corr}', 'pid': 0, 'tid': 7,
            'ts': ts, 'dur': 4, 'args': {'correlation': corr}}


def test_lost_launches_are_counted_and_mark_the_profile(tmp_path):
    """A capture that recorded launches but not their device work (what
    a capture from another thread sees late in a process on the card):
    every kind of work call counts, a call that launches nothing does
    not, nor do launches from the window's end (after the last device
    event, or after the stop's device-wide synchronize began). The event
    carries lost_launches, and either package's report reads it."""
    golden = tprofile.parse_trace(GOLDEN)
    assert golden.lost_launches == 0 and golden.complete
    assert 'lost_launches' not in golden.to_event()
    events = [_launch(1, 'cudaLaunchKernel', 0),
              _launch(2, 'cudaGraphLaunch', 1),
              _launch(3, 'cudaMemcpyAsync', 2),
              _launch(4, 'cuLaunchKernelEx', 3, 'cuda_driver'),
              _launch(5, 'cudaMemsetAsync', 4),
              _launch(6, 'cudaStreamSynchronize', 5),    # launches nothing
              _launch(7, 'cudaLaunchKernel', 50), _work(7, 60),
              _launch(8, 'cudaMemcpyAsync', 55), _work(8, 70, 'gpu_memcpy'),
              _launch(9, 'cudaLaunchKernel', 80),        # after the last end
              _launch(10, 'cudaDeviceSynchronize', 72),
              _launch(11, 'cudaLaunchKernel', 73)]       # after the sync
    (tmp_path / 'lost.pt.trace.json').write_text(json.dumps(
        {'traceEvents': events, 'deviceProperties': [{'id': 0}]}))
    p = tprofile.parse_trace(str(tmp_path))
    assert tprofile.count_lost_launches(events) == p.lost_launches == 5
    assert not p.complete and p.n_ops == 2
    ev = p.to_event(source='debug')
    assert ev['lost_launches'] == 5
    # all lost: no device event, no synchronize: every launch counts
    assert tprofile.count_lost_launches(events[:6]) == 5
    assert tprofile.count_lost_launches([]) == 0
    runs = [{'event': 'run_start', 'ts': 1.0, 'host': 0},
            dict(ev, ts=2.0, host=0),
            {'event': 'run_end', 'ts': 3.0, 'host': 0, 'wall_s': 2.0}]
    summary = treport.summarize(runs)
    assert summary == jreport.summarize(runs)
    assert summary['profile_captures'] == 1


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.body = torch.nn.Sequential(torch.nn.Conv2d(8, 8, 3, padding=1),
                                        torch.nn.ReLU(),
                                        torch.nn.Conv2d(8, 8, 1))
        self.head = torch.nn.Conv2d(8, 2, 1)

    def forward(self, x):
        return self.head(self.body(torch.relu(self.stem(x))))


def _step(net, x):
    net.zero_grad()
    net(x).square().mean().backward()


def test_cpu_fallback_modules_and_backward_join(tmp_path):
    """A trace captured here (no GPU): the outermost CPU ops, every
    forward and backward convolution attributed to its module (the
    backward through autograd's sequence numbers), the loss outside any
    module, and the hooks gone after the capture."""
    torch.manual_seed(0)
    net, x = _Net(), torch.randn(2, 3, 16, 16)
    _step(net, x)
    cap = tprofile.Capture((net,), depth=1)
    try:
        _step(net, x)
    finally:
        path = cap.stop(str(tmp_path))
    assert path.endswith('.pt.trace.json') and os.path.exists(path)
    assert not any(m._forward_pre_hooks or m._forward_hooks
                   for m in net.modules())
    p = tprofile.parse_trace(str(tmp_path), depth=1)
    assert not p.device_track and p.n_ops > 0
    assert set(p.modules) == {'stem', 'body', 'head'}
    assert p.categories['conv'] > 0 and 'unattributed' not in p.categories
    xevents, meta = tprofile.load_trace_events(str(tmp_path))
    ops, _ = tprofile.select_device_events(xevents, meta['gpus'])
    mods = tprofile.attribute_modules(xevents, ops, False, 2)
    convs = [(e['name'], m) for e, m in zip(ops, mods)
             if tprofile.categorize(e['name'], e['cat']) == 'conv']
    fwd = [m for n, m in convs if not n.startswith('autograd')]
    bwd = [m for n, m in convs if n.startswith('autograd')]
    # body's convs are body/0 and body/2 at depth 2 (ranges at depth 1
    # name `body` alone)
    assert sorted(fwd) == sorted(bwd) == ['body', 'body', 'head', 'stem']
    loss = [m for e, m in zip(ops, mods) if e['name'] == 'aten::square']
    assert loss == [None]
    # without module ranges nothing has a module
    cap = tprofile.Capture()
    try:
        _step(net, x)
    finally:
        cap.stop(str(tmp_path / 'bare'))
    assert tprofile.parse_trace(str(tmp_path / 'bare')).modules == {}


def test_module_ranges_close_when_a_forward_raises():
    class Boom(torch.nn.Module):
        def forward(self, x):
            raise ValueError('boom')

    net = torch.nn.Sequential(torch.nn.Linear(2, 2), Boom())
    with tprofile.module_ranges([net], depth=1):
        with pytest.raises(ValueError):
            net(torch.zeros(1, 2))
        net[0](torch.zeros(1, 2))          # the stack still balances
    assert not net[1]._forward_hooks and not net[0]._forward_pre_hooks
    assert tprofile.module_of('module:a/b/c', 2) == 'a/b'
    assert tprofile.module_of('train/dispatch', 2) is None


def test_capture_window_is_one_at_a_time(tmp_path):
    """capture_window parses its window and deletes a temporary trace;
    one given a trace_dir keeps it; any capture while another holds the
    profiler raises CaptureBusy, and the lock is free afterwards."""
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            torch.ones(64, 64) @ torch.ones(64, 64)

    th = threading.Thread(target=busy, daemon=True)
    th.start()
    try:
        prof = tprofile.capture_window(0.05)
        kept = tprofile.capture_window(0.02, trace_dir=str(tmp_path))
    finally:
        stop.set()
        th.join(timeout=10)
    assert isinstance(prof, tprofile.DeviceProfile) and not prof.device_track
    assert prof.to_event()['event'] == 'profile'
    assert tprofile._trace_files(str(tmp_path)) and kept.source == str(
        tmp_path)
    cap = tprofile.Capture()
    try:
        with pytest.raises(tprofile.CaptureBusy):
            tprofile.capture_window(0.01)
        with pytest.raises(tprofile.CaptureBusy):
            tprofile.Capture()
    finally:
        cap.abort()
    cap.abort()                              # idempotent
    assert tprofile._CAPTURE_LOCK.acquire(blocking=False)
    tprofile._CAPTURE_LOCK.release()


class _CountedStep:
    """A train step on `net` with the port steps' `_cache_size()`."""

    def __init__(self, net):
        self.net = net
        self.seen = set()

    def _cache_size(self):
        return len(self.seen)

    def __call__(self, x):
        self.seen.add(tuple(x.shape))
        _step(self.net, x)


def test_sampled_profiler_cadence_schema_and_retrace(tmp_path):
    """every=2, iters=2 over 7 steps: windows open after steps 2 and 4
    (and 6, closed early by finish); each emits one `profile` event with
    the JAX keys, ms_per_iter and the window's step; a window in which the
    step met a new input signature is flagged retraced; abort() releases
    a half-open window's lock."""
    torch.manual_seed(0)
    net = _Net()
    step = _CountedStep(net)
    sink = EventSink(str(tmp_path / 'events-000.jsonl'))
    reg = MetricsRegistry()
    sp = tprofile.SampledProfiler(sink, every=2, iters=2, jitted=step,
                                  registry=reg, models=(net,), depth=1)
    for i in range(7):
        sp.before_step()
        x = torch.randn(1 if i == 4 else 2, 3, 16, 16)
        step(x)
        sp.after_step(step=i + 1)
    sp.finish(step=7)
    sp.before_step()                 # seq 7: not on the cadence
    assert sp._active is None
    sink.close()
    events = [json.loads(line) for line in open(sink.path)]
    assert [(e['step'], e['iters'], e['retraced']) for e in events] == [
        (4, 2, False), (6, 2, True), (7, 1, False)]
    jax_keys = set(jprofile.parse_trace(JAX_GOLDEN).to_event(
        source='sampled', iters=1, retraced=False, wall_ms=1.0,
        ms_per_iter=1.0, step=1))
    for e in events:
        assert set(e) - {'ts', 'host'} == jax_keys
        assert e['source'] == 'sampled' and e['n_ops'] > 0
        assert set(e['modules']) <= {'stem', 'body', 'head'}
        assert e['ms_per_iter'] == pytest.approx(
            e['device_busy_ms'] / e['iters'], abs=2e-3)
    assert sp.captures == 3
    from rtseg_tpu_torch.obs.live import parse_prometheus
    from rtseg_tpu_torch.obs.metrics import render_prometheus
    parsed = parse_prometheus(render_prometheus(reg))
    assert parsed['profile_captures_total'][0][1] == 3
    # a window left open by a raising step: abort frees the profiler
    sp = tprofile.SampledProfiler(None, every=1, iters=3)
    sp.after_step()
    sp.before_step()
    assert sp._active is not None
    with pytest.raises(tprofile.CaptureBusy):
        tprofile.capture_window(0.01)
    sp.abort()
    sp.abort()
    assert sp.abort_errors == 0
    shutil.rmtree(tmp_path / 'x', ignore_errors=True)
    tprofile.capture_window(0.01)


def test_trainer_profile_dir_trace_and_sampled_captures(tmp_path):
    """SegTrainer.run() with profile_dir: a torch.profiler trace of epoch
    0's steps 1..profile_steps with module ranges (the sampled captures
    stand down meanwhile, as in the JAX trainer); with profile_every, one
    sampled `profile` event in epoch 1 on the cadence."""
    from rtseg_tpu_torch.config import SegConfig
    from rtseg_tpu_torch.train import SegTrainer
    cfg = SegConfig(dataset='synthetic', model='fastscnn', num_class=5,
                    crop_size=32, train_bs=4, val_bs=4, synthetic_len=16,
                    total_epoch=2, val_interval=1, compute_dtype='float32',
                    base_workers=0, log_interval=0, load_ckpt=False,
                    save_ckpt=False, use_tb=False, profile_every=2,
                    profile_capture_iters=1, profile_steps=2,
                    profile_dir=str(tmp_path / 'trace'),
                    save_dir=str(tmp_path))
    cfg.resolve()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = SegTrainer(cfg, device='cpu')
        trainer.run()
    finally:
        torch.set_num_threads(n)
    xevents, _ = tprofile.load_trace_events(str(tmp_path / 'trace'))
    steps = [e for e in xevents if e.get('cat') == 'user_annotation'
             and e['name'] == 'train/dispatch']
    assert len(steps) == cfg.profile_steps
    top = {name for name, _ in trainer.model.named_children()}
    p = tprofile.parse_trace(str(tmp_path / 'trace'), depth=1)
    assert p.n_ops > 0 and set(p.modules) == top
    deep = tprofile.parse_trace(str(tmp_path / 'trace'), depth=4)
    assert max(m.count('/') for m in deep.modules) >= 2
    events = [json.loads(line) for line in
              open(tmp_path / 'segscope' / 'events-000.jsonl')]
    profs = [e for e in events if e['event'] == 'profile']
    assert [(e['step'], e['iters'], e['retraced']) for e in profs] == [
        (7, 1, False)]
    assert set(profs[0]['modules']) and profs[0]['n_ops'] > 0
    s = treport.summarize(events)
    assert s['device']['captures'] == 1 and s['dev_conv_ms'] > 0
