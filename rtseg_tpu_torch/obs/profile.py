"""Device-time attribution from torch.profiler traces (counterpart of
rtseg_tpu/obs/profile.py, which reads the traces jax.profiler writes).

One parser (:func:`parse_trace`) turns the Chrome-trace JSON that
``torch.profiler`` exports (``*.trace.json``, plain or ``.gz``) into a
:class:`DeviceProfile` with the JAX dataclass's fields:

  * device time by **category** (:func:`categorize`): the JAX package's
    six CATEGORIES for CUDA kernel names, the port's two hand-written
    kernels under buckets of their own (``resize_argmax``, K1;
    ``confusion_matrix``, K2), everything else under a base name
    (``elementwise``, ``reduce``, ``batch_norm``, ...); only a name with
    no identifier in it is ``unattributed``;
  * device time by model **module**: inside a capture, forward pre- and
    post-hooks on the model's submodules (:func:`module_ranges`) open
    ``record_function`` ranges named ``module:<Flax path>``, the port's
    module names with ``/`` for ``.``. A kernel belongs to the innermost
    range that encloses its launch (the ``cuda_runtime`` or
    ``cuda_driver`` event with the kernel's ``correlation``); a backward
    kernel, launched from autograd's thread outside any range, belongs to
    the module of the forward op that shares its ``Sequence number`` (so
    forward and backward of one module add up, as the JAX parser's
    dropping of ``transpose(`` does). A kernel launched outside every
    range, a replayed CUDA graph's kernel (no launch event of its own),
    and a kernel whose forward op is ambiguous or outside the capture
    have module None, as an op without source metadata has in JAX;
  * device **busy** time (the union of the device events' intervals over
    every stream, so a side stream's copy under a kernel is not counted
    twice), the window from the first device event's start to the last
    one's end, its idle share, and the top ops by summed duration;
  * **lost launches** (:func:`count_lost_launches`): kernel, graph, copy
    and memset launches the trace recorded whose device work it did not.
    A profile with any is incomplete, and says so: the ``profile`` event
    carries ``lost_launches``; a capture of other threads' work alone
    gives none of its numbers: ``POST /debug/profile`` answers 503, and
    the stall event's ``top_device_ops`` is None beside
    ``lost_launches``. A sampled capture runs on the step's own thread,
    whose work it keeps, so it can lose only what other threads
    launched (the loader's copies): its event is emitted and read.

Device events are the GPU track's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. A trace without a GPU (no such events and no
``deviceProperties``, as on a CPU-only machine) falls back to the
outermost ``cpu_op`` events of each thread, as the JAX parser falls back
to the XLA CPU backend's HLO events; a GPU trace never does.

Three capture surfaces share the parser and one process-wide capture
lock, since torch.profiler is one per process:

  * :class:`SampledProfiler`: every N train steps the trainer fences the
    card, captures K iterations, parses, emits one ``profile`` event and
    deletes the trace;
  * :func:`capture_window`: a bounded wall-clock window from any thread
    (the serve front end's ``POST /debug/profile``, the stall watchdog);
    raises :class:`CaptureBusy` instead of queueing;
  * the trainer's ``profile_dir`` trace of epoch 0 (train/trainer.py).

torch.profiler records CPU ops and ``record_function`` ranges on the
thread that started it (and autograd's threads, which inherit its state);
CUPTI's kernel and launch records cover the whole process. So a capture
started from another thread than the one launching the work still counts
the work's device time and categories, and attributes its modules to
None. On an H100 with PyTorch 2.11, though, such a capture keeps the
other thread's launches but drops their kernels for the first D ms of
its window, D growing by 2-3 ms for each second since the process's
first profiler session (PERF.md, ROADMAP.md Queue 3): in a process that
has profiled for minutes, a capture from the HTTP handler's or the
watchdog's thread sees none of the work. That is what the lost-launch
count detects.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
import threading
import time
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from .core import EventSink, cache_size

#: the fixed attribution categories (everything else is attributed under
#: a named base; see categorize()), the JAX package's six
CATEGORIES = ('conv', 'matmul', 'collective', 'copy', 'fusion', 'infeed')

#: the port's hand-written kernels (ops/csrc/): kernel function -> bucket,
#: named after the wrapper that launches it
KERNEL_BUCKETS = {'head_argmax_kernel': 'resize_argmax',
                  'confusion_kernel': 'confusion_matrix'}

#: prefix of the record_function ranges that name a module
MODULE_RANGE = 'module:'

#: trace event categories of work on the card, and of its launches
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
#: the runtime and driver calls whose device work carries their
#: correlation: cudaLaunchKernel, cuLaunchKernel(Ex), cudaGraphLaunch,
#: cudaMemcpy*, cudaMemset*
_WORK_CALLS = ('LaunchKernel', 'GraphLaunch', 'Memcpy', 'Memset')

# conv before matmul: cuDNN's convolution kernels carry `implicit_gemm`
_CONV_MARKS = ('fprop', 'dgrad', 'wgrad', 'convolve', 'conv2d',
               'convolution', 'conv_depthwise', 'depthwise', 'im2col',
               'col2im', 'winograd')
_MATMUL_MARKS = ('gemm', 'gemv', 'matmul', 'nvjet', 'cublas', 'cutlass')
_MATMUL_OPS = ('mm', 'addmm', 'bmm', 'baddbmm', 'linear', 'dot', 'einsum')
_COLLECTIVE_MARKS = ('allreduce', 'all_reduce', 'allgather',
                     'all_gather', 'reduce_scatter', 'alltoall',
                     'all_to_all', 'broadcast')
_COPY_OPS = ('copy', 'to', 'to_copy', 'contiguous', 'clone', 'memcpy',
             'direct_copy')
# named buckets by a mark in the kernel or op identifier, first match
_FAMILIES = (('batch_norm', 'batch_norm'), ('bn_fw', 'batch_norm'),
             ('bn_bw', 'batch_norm'), ('welford', 'batch_norm'),
             ('layer_norm', 'layer_norm'), ('layernorm', 'layer_norm'),
             ('group_norm', 'group_norm'), ('softmax', 'softmax'),
             ('upsample', 'upsample'), ('interpolat', 'upsample'),
             ('pool', 'pool'), ('dropout', 'dropout'),
             ('distribution', 'random'), ('multi_tensor_apply',
                                          'optimizer'),
             ('scatter', 'scatter'), ('gather', 'gather'),
             ('index', 'index'), ('sort', 'sort'), ('topk', 'sort'),
             ('catarraybatchedcopy', 'cat'), ('nchwtonhwc', 'layout'),
             ('nhwctonchw', 'layout'), ('transpose', 'layout'),
             ('reduce', 'reduce'), ('elementwise', 'elementwise'))

_ANON = re.compile(r'\((anonymous namespace|lambda[^)]*)\)')
_IDENT = re.compile(r'[A-Za-z_][A-Za-z0-9_]*')


def _identifier(name: str) -> str:
    """The function identifier of a kernel's C++ signature or an op's
    name: `void at::native::reduce_kernel<512, 1, ...>(...)` ->
    `reduce_kernel`, `aten::conv2d` -> `conv2d`, `autograd::engine::
    evaluate_function: ConvolutionBackward0` -> `ConvolutionBackward0`;
    '' when there is none."""
    name = (name or '').rsplit(': ', 1)[-1]
    if name.startswith('void '):
        name = name[5:]
    name = _ANON.sub('anon', name)
    depth, top = 0, []
    for ch in name:
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == '(':
                break
            top.append(ch)
    found = _IDENT.findall(''.join(top).rsplit('::', 1)[-1])
    return found[-1] if found else ''


def categorize(name: str, cat: Optional[str] = None) -> str:
    """CUDA kernel or CPU op name (with its trace category) -> bucket.

    The JAX package's six CATEGORIES where one applies: memcpy and
    memset events and copy kernels and ops -> copy; nccl and the c10d
    collectives -> collective; cuDNN's fprop, dgrad, wgrad and
    implicit_convolve kernels and PyTorch's own convolutions -> conv,
    checked before matmul, since cuDNN's conv kernels carry
    `implicit_gemm`; cuBLAS, CUTLASS and other gemm kernels and the
    matmul ops -> matmul; Triton's generated kernels -> fusion. The
    port's two kernels go to their own buckets (KERNEL_BUCKETS). The rest
    goes to a base name: a family of `_FAMILIES` or the identifier
    lower-cased, without a trailing `_kernel` or `_` (an autograd node's
    `ClampMinBackward0` reads as its forward's `clamp_min`). Only
    a name with no identifier is `unattributed`."""
    if cat in ('gpu_memcpy', 'gpu_memset'):
        return 'copy'
    ident = _identifier(name)
    if ident in KERNEL_BUCKETS:
        return KERNEL_BUCKETS[ident]
    low = (name or '').lower()
    grad = re.match(r'(\w+?)Backward\d*$', ident)
    if grad:                       # autograd's node: ClampMinBackward0
        ident = re.sub(r'(?<!^)(?=[A-Z])', '_', grad.group(1))
    base = (re.sub(r'(_kernel\w*|kernel)$', '', ident.lower()).strip('_')
            or ident.lower())
    if not base:
        return 'unattributed'
    if 'nccl' in low or any(m in base for m in _COLLECTIVE_MARKS):
        return 'collective'
    if 'convert' not in base and (
            any(m in base for m in _CONV_MARKS)
            or any(m in low for m in ('fprop', 'dgrad', 'wgrad',
                                      'implicit_convolve'))
            or ('cudnn' in low and ('gemm' in low or 'conv' in low))):
        return 'conv'
    if base in _MATMUL_OPS or any(m in low for m in _MATMUL_MARKS):
        return 'matmul'
    if base.startswith('triton_') or 'fusion' in base:
        return 'fusion'
    if base in _COPY_OPS or 'copy_kernel' in low or (
            base.endswith('copy') and 'cat' not in base):
        return 'copy'
    for mark, family in _FAMILIES:
        if mark in base:
            return family
    return base


def module_of(range_name: str, depth: int = 1) -> Optional[str]:
    """The module path (to `depth` components) of a `module:` range name;
    None for any other range (a span's, the profiler's own)."""
    if not (range_name or '').startswith(MODULE_RANGE):
        return None
    parts = [p for p in range_name[len(MODULE_RANGE):].split('/') if p]
    return '/'.join(parts[:depth]) if parts else None


@contextmanager
def module_ranges(models: Iterable[torch.nn.Module], depth: int
                  ) -> Iterator[None]:
    """Forward pre- and post-hooks on every submodule of `models` at
    most `depth` deep that open and close a `module:<Flax path>`
    record_function range around its forward, removed on exit. The ranges
    nest by thread (a rematerialized forward's recompute runs on
    autograd's thread); the post-hook runs also when the forward raises,
    so a range never outlives its module."""
    local = threading.local()
    handles = []

    def pre(label):
        def hook(module, args):
            stack = getattr(local, 'stack', None)
            if stack is None:
                stack = local.stack = []
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            stack.append(rf)
        return hook

    def post(module, args, output):
        stack = getattr(local, 'stack', None)
        if stack:
            stack.pop().__exit__(None, None, None)

    try:
        for model in models:
            for name, mod in model.named_modules():
                if not name or name.count('.') >= depth:
                    continue
                label = MODULE_RANGE + name.replace('.', '/')
                handles.append(mod.register_forward_pre_hook(pre(label)))
                handles.append(mod.register_forward_hook(post,
                                                         always_call=True))
        yield
    finally:
        for h in handles:
            h.remove()


# ------------------------------------------------------------------ parser
def _trace_files(trace_dir: str) -> List[str]:
    files = []
    for pattern in ('*.trace.json', '*.trace.json.gz'):
        files += glob.glob(os.path.join(trace_dir, '**', pattern),
                           recursive=True)
    return sorted(files, key=os.path.getmtime)


def load_trace_events(trace_dir: str) -> Tuple[List[dict], Dict[str, Any]]:
    """The complete ('X') events of the newest ``*.trace.json`` or
    ``*.trace.json.gz`` under `trace_dir`, and the trace's metadata:
    ``pid_names`` (pid -> process name) and ``gpus`` (the
    ``deviceProperties`` torch.profiler writes when it traced a card)."""
    files = _trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f'no *.trace.json[.gz] under {trace_dir}')
    opener = gzip.open if files[-1].endswith('.gz') else open
    with opener(files[-1], 'rt') as f:
        data = json.load(f)
    events = data['traceEvents'] if isinstance(data, dict) else data
    gpus = (data.get('deviceProperties') or []) if isinstance(
        data, dict) else []
    pid_names = {e.get('pid'): (e.get('args') or {}).get('name', '')
                 for e in events
                 if e.get('ph') == 'M' and e.get('name') == 'process_name'}
    xevents = [e for e in events if e.get('ph') == 'X']
    return xevents, {'pid_names': pid_names, 'gpus': gpus}


def _line(e: dict) -> Tuple[Any, Any]:
    return e.get('pid'), e.get('tid')


def _end(e: dict) -> float:
    return float(e.get('ts', 0.0)) + float(e.get('dur', 0.0))


def _outermost(events: List[dict]) -> List[dict]:
    """The events of each thread that no other of its events encloses."""
    out = []
    by_line = collections.defaultdict(list)
    for e in events:
        by_line[_line(e)].append(e)
    for evs in by_line.values():
        evs.sort(key=lambda e: (float(e['ts']), -float(e['dur'])))
        end = float('-inf')
        for e in evs:
            if float(e['ts']) >= end:
                out.append(e)
            end = max(end, _end(e))
    return out


def select_device_events(xevents: List[dict], gpus: Sequence = ()
                         ) -> Tuple[List[dict], bool]:
    """The ops to attribute: (events, device_track_found).

    A GPU trace's ops are its kernel, memcpy and memset events on every
    stream (none of them is a container of another). A trace without a
    GPU falls back to each thread's outermost ``cpu_op`` events (an op's
    nested ATen calls are inside it, and counting them too would count
    its time twice)."""
    dev = [e for e in xevents if e.get('cat') in DEVICE_CATS
           and float(e.get('dur', 0)) > 0]
    if dev or gpus:
        return dev, True
    ops = [e for e in xevents if e.get('cat') == 'cpu_op'
           and float(e.get('dur', 0)) > 0]
    return _outermost(ops), False


def _innermost(intervals: List[Tuple[float, float, Any]],
               points: List[float]) -> List[Any]:
    """For each point, the label of the innermost of `intervals` (one
    thread's, properly nested: (start, end, label)) that encloses it, or
    None."""
    iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out: List[Any] = [None] * len(points)
    stack: List[Tuple[float, float, Any]] = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        p = points[j]
        while i < len(iv) and iv[i][0] <= p:
            while stack and stack[-1][1] < iv[i][0]:
                stack.pop()
            stack.append(iv[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[j] = stack[-1][2] if stack else None
    return out


def _lookup(intervals: Dict[Any, list], queries: List[Tuple[Any, float]]
            ) -> List[Any]:
    """`_innermost` over many threads: queries are (line, ts)."""
    out: List[Any] = [None] * len(queries)
    by_line = collections.defaultdict(list)
    for k, (line, ts) in enumerate(queries):
        by_line[line].append((k, ts))
    for line, qs in by_line.items():
        if line not in intervals:
            continue
        got = _innermost(intervals[line], [ts for _, ts in qs])
        for (k, _), label in zip(qs, got):
            out[k] = label
    return out


def attribute_modules(xevents: List[dict], ops: List[dict],
                      device_track: bool, depth: int) -> List[Optional[str]]:
    """The module (to `depth` components) of each op, None where none can
    be named: through its launch's enclosing `module:` range, or through
    the forward op that shares the `Sequence number` of the backward op
    that launched it (see the module docstring)."""
    ranges = collections.defaultdict(list)
    seq_ops = collections.defaultdict(list)
    launches = {}
    for e in xevents:
        cat, args = e.get('cat'), e.get('args') or {}
        if cat == 'user_annotation':
            mod = module_of(e.get('name', ''), depth)
            if mod is not None:
                ranges[_line(e)].append((float(e['ts']), _end(e), mod))
        elif cat == 'cpu_op' and 'Sequence number' in args:
            bwd = int(args.get('Fwd thread id', 0) or 0) != 0
            seq_ops[_line(e)].append((float(e['ts']), _end(e),
                                      (int(args['Sequence number']), bwd)))
        elif cat in LAUNCH_CATS and 'correlation' in args:
            launches[args['correlation']] = (_line(e), float(e['ts']))
    # where each op was issued on the host: its launch, or itself
    points: List[Optional[Tuple[Any, float]]] = []
    for e in ops:
        if device_track:
            points.append(launches.get((e.get('args') or {})
                                       .get('correlation')))
        else:
            points.append((_line(e), float(e['ts'])))
    issued = [p for p in points if p is not None]
    direct = iter(_lookup(ranges, issued))
    seq_of = iter(_lookup(seq_ops, issued))
    # a forward op's sequence number -> the modules its ops ran under
    fwd = [(line, ts, key[0]) for line, ivs in seq_ops.items()
           for ts, _, key in ivs if not key[1]]
    fwd_mods = collections.defaultdict(set)
    for (_, _, seq), mod in zip(fwd, _lookup(
            ranges, [(line, ts) for line, ts, _ in fwd])):
        fwd_mods[seq].add(mod)
    out: List[Optional[str]] = []
    for p in points:
        if p is None:
            out.append(None)
            continue
        mod, key = next(direct), next(seq_of)
        if mod is None and key is not None and key[1]:
            mods = fwd_mods.get(key[0], set())
            mod = next(iter(mods)) if len(mods) == 1 else None
        out.append(mod)
    return out


def count_lost_launches(xevents: List[dict]) -> int:
    """The launches of device work (`_WORK_CALLS`, any thread) that the
    trace recorded and whose kernel, copy or memset it did not (no device
    event has their correlation).

    Launches from the end of the window are not counted: those issued
    after the last recorded device event ended, or after the stop's
    device-wide synchronize began, may run after the profiler stopped
    recording. A CPU-only trace records no launches: 0."""
    done, launched, syncs, ends = set(), [], [], []
    for e in xevents:
        cat, args = e.get('cat'), e.get('args') or {}
        if cat in DEVICE_CATS:
            done.add(args.get('correlation'))
            ends.append(_end(e))
        elif cat in LAUNCH_CATS:
            name = e.get('name', '')
            if name == 'cudaDeviceSynchronize':
                syncs.append(float(e.get('ts', 0.0)))
            elif 'correlation' in args and any(c in name
                                               for c in _WORK_CALLS):
                launched.append((float(e.get('ts', 0.0)),
                                 args['correlation']))
    cutoff = min(max(syncs, default=float('inf')),
                 max(ends, default=float('inf')))
    return sum(1 for ts, corr in launched
               if ts < cutoff and corr not in done)


def _union_us(ops: List[dict]) -> float:
    busy, end = 0.0, float('-inf')
    for ts, e in sorted((float(e['ts']), _end(e)) for e in ops):
        if e <= end:
            continue
        busy += e - max(ts, end)
        end = e
    return busy


@dataclass
class DeviceProfile:
    """Parsed device-time attribution for one capture window.

    Durations are microseconds (trace-viewer native); ``to_event`` and
    the HTTP surfaces convert to ms.
    """
    window_us: float = 0.0                 # first op start -> last op end
    busy_us: float = 0.0                   # union of the ops' intervals
    n_ops: int = 0
    device_track: bool = False             # GPU events vs CPU ops
    categories: Dict[str, float] = field(default_factory=dict)   # us
    modules: Dict[str, float] = field(default_factory=dict)      # us
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    source: str = ''
    lost_launches: int = 0                 # launches whose work is missing

    @property
    def complete(self) -> bool:
        """Whether the trace holds the device work of every launch it
        recorded (count_lost_launches)."""
        return self.lost_launches == 0

    @property
    def busy_frac(self) -> float:
        """Busy time / capture window, clamped to 1.0."""
        if self.window_us <= 0:
            return 0.0
        return min(1.0, self.busy_us / self.window_us)

    @property
    def idle_us(self) -> float:
        return max(0.0, self.window_us - self.busy_us)

    @property
    def attributed_frac(self) -> float:
        """Share of busy time in a *named* bucket (category or base
        name); the complement is events whose name has no identifier."""
        if self.busy_us <= 0:
            return 1.0
        return max(0.0, 1.0 - self.categories.get('unattributed', 0.0)
                   / self.busy_us)

    def to_event(self, **extra: Any) -> Dict[str, Any]:
        """The structured ``profile`` event (the JAX package's keys; also
        the ``POST /debug/profile`` response body), with
        ``lost_launches`` besides where the profile is incomplete."""
        ev: Dict[str, Any] = {
            'event': 'profile',
            'window_ms': round(self.window_us / 1e3, 3),
            'device_busy_ms': round(self.busy_us / 1e3, 3),
            'idle_ms': round(self.idle_us / 1e3, 3),
            'busy_frac': round(self.busy_frac, 4),
            'attributed_frac': round(self.attributed_frac, 4),
            'n_ops': self.n_ops,
            'device_track': self.device_track,
            'categories': {k: round(v / 1e3, 3)
                           for k, v in sorted(self.categories.items(),
                                              key=lambda kv: -kv[1])},
            'modules': {k: round(v / 1e3, 3)
                        for k, v in sorted(self.modules.items(),
                                           key=lambda kv: -kv[1])[:12]},
            'top_ops': [[n, round(us / 1e3, 3)]
                        for n, us in self.top_ops[:5]],
        }
        if self.lost_launches:
            ev['lost_launches'] = self.lost_launches
        ev.update(extra)
        return ev


def parse_trace(trace_dir: str, depth: int = 2) -> DeviceProfile:
    """Parse the newest trace under ``trace_dir`` into a DeviceProfile;
    modules aggregate at ``depth`` path components."""
    xevents, meta = load_trace_events(trace_dir)
    ops, device_track = select_device_events(xevents, meta['gpus'])
    categories: collections.Counter = collections.Counter()
    modules: collections.Counter = collections.Counter()
    per_op: collections.Counter = collections.Counter()
    for e, mod in zip(ops, attribute_modules(xevents, ops, device_track,
                                             depth)):
        dur = float(e.get('dur', 0.0))
        name = e.get('name', '')
        categories[categorize(name, e.get('cat'))] += dur
        per_op[name or '(unnamed)'] += dur
        if mod is not None:
            modules[mod] += dur
    t0 = min((float(e['ts']) for e in ops), default=0.0)
    t1 = max((_end(e) for e in ops), default=0.0)
    return DeviceProfile(
        window_us=t1 - t0, busy_us=_union_us(ops), n_ops=len(ops),
        device_track=device_track, categories=dict(categories),
        modules=dict(modules), top_ops=per_op.most_common(8),
        source=trace_dir, lost_launches=count_lost_launches(xevents))


# ---------------------------------------------------------------- capture
class CaptureBusy(RuntimeError):
    """A profiler capture is already in progress (torch.profiler is one
    per process; concurrent captures are refused, not queued)."""


#: one capture at a time, process-wide: every acquire is non-blocking, so
#: no caller ever waits out another's window
_CAPTURE_LOCK = threading.Lock()


def _activities() -> list:
    """CPU, and CUDA wherever a card is: a capture on a machine with a
    card always traces it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def fence() -> None:
    """Wait for the card's queued work (nothing without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Capture:
    """One torch.profiler session that holds the capture lock, with
    module ranges on `models` (at most `depth` deep) while it runs.
    Raises CaptureBusy when another capture holds the lock. `stop`
    writes the trace into a directory; `abort` drops it. Either releases
    the lock, once."""

    def __init__(self, models: Iterable[torch.nn.Module] = (),
                 depth: int = 2):
        if not _CAPTURE_LOCK.acquire(blocking=False):
            raise CaptureBusy('a profiler capture is already in progress')
        self._stack = ExitStack()
        try:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
            self._stack.callback(self._prof.stop)
            self._stack.enter_context(module_ranges(models, depth))
        except BaseException:
            self._stack.close()
            _CAPTURE_LOCK.release()
            raise
        self._open = True

    def _close(self) -> None:
        if not self._open:
            return
        self._open = False
        try:
            self._stack.close()           # ranges off, profiler stopped
        finally:
            _CAPTURE_LOCK.release()

    def stop(self, trace_dir: str) -> str:
        """Stop, release the lock, and export the trace (outside the
        lock) to a new ``*.pt.trace.json`` in `trace_dir`; its path."""
        self._close()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir,
                            f'capture-{time.time_ns()}.pt.trace.json')
        self._prof.export_chrome_trace(path)
        return path

    def abort(self) -> None:
        self._close()


def capture_window(duration_s: float, depth: int = 2,
                   trace_dir: Optional[str] = None) -> DeviceProfile:
    """Trace a bounded wall-clock window and parse it.

    The calling thread sleeps for ``duration_s`` while other threads keep
    launching work (the live-traffic capture behind ``POST
    /debug/profile``); their kernels are counted, their modules are None
    (no range of another thread is recorded). A profile whose trace lost
    some of their kernels says so in ``lost_launches`` (see the module
    docstring): callers check ``complete``. The trace is deleted after
    parsing unless the caller supplied ``trace_dir``. Raises
    :class:`CaptureBusy` when another capture (sampled, on-demand or
    profile_dir) holds the profiler."""
    cap = Capture()
    tmp = trace_dir is None
    target = trace_dir or tempfile.mkdtemp(prefix='segprof_')
    try:
        try:
            time.sleep(max(0.0, float(duration_s)))
        finally:
            cap.stop(target)
        return parse_trace(target, depth=depth)
    finally:
        if tmp:
            shutil.rmtree(target, ignore_errors=True)


class SampledProfiler:
    """Continuous sampled profiling for the trainer loop.

    Every ``every`` completed steps the next ``iters`` iterations are
    captured: the card is fenced so the window opens idle, torch.profiler
    traces the iterations with module ranges on ``models``, the card is
    fenced again, and the parsed breakdown is emitted as ONE ``profile``
    event into the sink (plus ``device_busy_frac`` and the capture
    counter on the live MetricsRegistry). The trace is deleted after
    parsing: the JSONL event *is* the artifact.

    The step's signature count (obs/core.py cache_size) is recorded when
    the window opens; a capture during which it grew (a new input
    signature paid its one-time costs inside the window) is emitted
    flagged ``retraced: true``, and consumers (the report) exclude it
    from attribution.

    Non-capture steps pay one integer compare per hook; a capture that
    cannot start (the profiler is busy, as under the trainer's
    profile_dir trace or a /debug/profile capture) is skipped, never
    raised: telemetry must not break the run.
    """

    def __init__(self, sink: Optional[EventSink], every: int,
                 iters: int = 2, jitted: Any = None,
                 registry: Any = None, depth: int = 2,
                 logger: Any = None,
                 models: Sequence[torch.nn.Module] = ()):
        self.sink = sink
        self.every = max(1, int(every))
        self.iters = max(1, int(iters))
        self.jitted = jitted
        self.depth = depth
        self.logger = logger
        self.models = tuple(models)
        self.captures = 0
        #: half-open-window teardowns that raised (abort() is best-effort
        #: but must not be silent)
        self.abort_errors = 0
        self._seq = 0                      # completed steps seen
        self._active: Optional[dict] = None
        self._disabled = False
        self._g_busy = self._c_caps = None
        if registry is not None:
            self._g_busy = registry.gauge(
                'device_busy_frac',
                help='device busy fraction of the last profile capture')
            self._c_caps = registry.counter(
                'profile_captures_total',
                help='sampled/on-demand profile captures completed')

    def abort(self) -> None:
        """Tear down a half-open capture window (a step raised between
        the hooks): stop the profiler, release the capture lock. Safe to
        call when no window is open."""
        a, self._active = self._active, None
        if a is None:
            return
        try:
            a['capture'].abort()
        except Exception:   # noqa: BLE001 — best-effort teardown, counted
            self.abort_errors += 1

    # ------------------------------------------------------------- hooks
    def before_step(self, state: Any = None) -> None:
        """Call before launching a step; opens a capture window on the
        cadence boundary (fence + start)."""
        if (self._active is not None or self._disabled or self._seq == 0
                or self._seq % self.every or _CAPTURE_LOCK.locked()):
            return                         # (another capture: no fence)
        try:
            fence()
            cap = Capture(self.models, self.depth)
        except CaptureBusy:
            return                         # another capture is running
        self._active = {'capture': cap, 'remaining': self.iters,
                        'cache0': cache_size(self.jitted)
                        if self.jitted is not None else None,
                        't0': time.perf_counter(), 'step0': self._seq}

    def after_step(self, state: Any = None,
                   step: Optional[int] = None) -> None:
        """Call after each completed step; closes the window once
        ``iters`` captured iterations have run (fence + stop + parse +
        emit)."""
        self._seq += 1
        a = self._active
        if a is None:
            return
        a['remaining'] -= 1
        if a['remaining'] > 0:
            return
        self._close(step=step, captured=self.iters)

    def finish(self, state: Any = None, step: Optional[int] = None) -> None:
        """Close a window left open at the end of a loop (the cadence
        boundary fell on the epoch's last steps), emitted with the
        iterations it actually captured: left open, validation and
        checkpoint work would pollute the trace and hold the capture lock
        across the val phase."""
        a = self._active
        if a is None:
            return
        captured = self.iters - a['remaining']
        if captured <= 0:
            self.abort()
            return
        self._close(step=step, captured=captured)

    def _close(self, step: Optional[int], captured: int) -> None:
        a, self._active = self._active, None
        trace_dir = tempfile.mkdtemp(prefix='segprof_train_')
        try:
            try:
                fence()               # all windowed work inside the trace
            finally:
                a['capture'].stop(trace_dir)
            prof = parse_trace(trace_dir, depth=self.depth)
        except Exception:   # noqa: BLE001 — never raise into the run
            a['capture'].abort()
            if self.logger is not None:
                self.logger.warning(
                    'segprof: a sampled capture failed; sampled profiling '
                    'is off for the rest of this run')
            self._disabled = True
            return
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        self.captures += 1
        retraced = False
        if a['cache0'] is not None:
            size = cache_size(self.jitted)
            retraced = size is not None and size > a['cache0']
        wall_ms = (time.perf_counter() - a['t0']) * 1e3
        if self._c_caps is not None:
            self._c_caps.inc()
            if not retraced:
                self._g_busy.set(prof.busy_frac)
        if self.sink is not None:
            ev = prof.to_event(
                source='sampled', iters=captured, retraced=retraced,
                wall_ms=round(wall_ms, 3),
                ms_per_iter=round(prof.busy_us / 1e3 / captured, 3))
            if step is not None:
                ev['step'] = step
            self.sink.emit(ev)
