"""Per-step wall-time collector for the trainer's train and val loops
(counterpart of rtseg_tpu/obs/collector.py).

Splits each loop iteration into the two host-observable phases:

  * ``data_wait``  — time blocked on the loader iterator (``wrap``), and
  * ``dur``        — time from batch receipt to ``end_step`` (the step's
    launches; under CUDA's asynchronous launches this is launch cost
    except when the queue applies backpressure, which is exactly when it
    matters).

Every iteration emits one ``step`` JSONL event. Compile time is
attributed through the step's signature count (train/step.py
``_cache_size``, read by obs/core.py ``cache_size``): a step during which
the count grew met a new input signature, where eager PyTorch pays its
one-time costs (cuDNN's algorithm search, lazy module loading, the first
build or load of the kernels), so its duration is flagged ``compile`` and
excluded from goodput and throughput downstream (obs/report.py), as the
JAX collector flags a step that grew the jit cache. The collector also
heartbeats the stall watchdog — once when a batch arrives, once when the
step returns, feeding it steady-state step durations so the stall
deadline adapts to the workload.

``interval_stats`` serves the trainer's progress line (imgs/sec and
data-wait fraction since the previous log point) from host timing alone:
it never reads a device value.

With a ``registry`` (obs/metrics.py), every ``end_step`` also feeds the
live metrics plane: a step-duration histogram (non-compile steps only,
matching the report's percentile definition), steps/images/compile-step
counters and data-wait/goodput gauges, all labeled by loop kind.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Iterator, Optional, Tuple

from .core import EventSink
from .core import cache_size as _cache_size
from .metrics import MetricsRegistry


class StepCollector:
    def __init__(self, sink: Optional[EventSink], kind: str,
                 imgs_per_step: int, jitted: Any = None,
                 watchdog: Any = None, epoch: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.sink = sink
        self.kind = kind
        self.imgs_per_step = int(imgs_per_step)
        self.jitted = jitted
        self.watchdog = watchdog
        self.epoch = epoch
        self._cache_last = (_cache_size(jitted)
                           if jitted is not None else None)
        self._n = 0
        self._data_wait = 0.0
        self._step_t0: Optional[float] = None
        # loop totals
        self.total_dur = 0.0
        self.total_wait = 0.0
        self.compile_s = 0.0
        self.n_compile = 0
        # progress-line interval window
        self._int_t0 = time.perf_counter()
        self._int_wait = 0.0
        self._int_imgs = 0
        # live metrics plane (None -> sink-only, zero extra work)
        self.registry = registry
        self._t_created = time.perf_counter()
        if registry is not None:
            self._h_step = registry.histogram(
                'train_step_ms',
                help='non-compile step duration (ms)', kind=kind)
            self._c_steps = registry.counter(
                'train_steps_total', help='loop iterations', kind=kind)
            self._c_compile = registry.counter(
                'train_compile_steps_total',
                help='steps that met a new input signature (one-time costs)',
                kind=kind)
            self._c_imgs = registry.counter(
                'train_imgs_total', help='images consumed', kind=kind)
            self._g_wait = registry.gauge(
                'train_data_wait_frac',
                help='fraction of loop wall blocked on the loader',
                kind=kind)
            self._g_goodput = registry.gauge(
                'train_goodput',
                help='productive non-compile step time / loop wall so '
                     'far (live approximation of the report goodput)',
                kind=kind)

    @property
    def n_steps(self) -> int:
        return self._n

    def wrap(self, iterable: Iterable) -> Iterator:
        """Iterate ``iterable`` while timing how long each ``next()``
        blocks (the data-wait phase of the step that follows)."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self._data_wait = time.perf_counter() - t0
            if self.watchdog is not None:
                self.watchdog.beat()
            self._step_t0 = time.perf_counter()
            yield item

    def end_step(self, step: Optional[int] = None) -> None:
        """Close the current iteration: emit its ``step`` event, attribute
        compile time, heartbeat the watchdog. Call at the end of the loop
        body, after the step dispatch (and any cheap host bookkeeping)."""
        now = time.perf_counter()
        if self._step_t0 is None:
            return
        dur = now - self._step_t0
        self._step_t0 = None
        self._n += 1
        compiled = False
        if self.jitted is not None:
            size = _cache_size(self.jitted)
            if size is not None:
                if self._cache_last is not None and size > self._cache_last:
                    compiled = True
                self._cache_last = size
        if compiled:
            self.compile_s += dur
            self.n_compile += 1
        self.total_dur += dur
        self.total_wait += self._data_wait
        self._int_wait += self._data_wait
        self._int_imgs += self.imgs_per_step
        if self.registry is not None:
            self._c_steps.inc()
            self._c_imgs.inc(self.imgs_per_step)
            if compiled:
                self._c_compile.inc()
            else:
                self._h_step.observe(dur * 1e3)
            wall = now - self._t_created
            if wall > 0:
                busy = self.total_dur + self.total_wait
                self._g_wait.set(self.total_wait / busy if busy else 0.0)
                self._g_goodput.set(
                    (self.total_dur - self.compile_s) / wall)
        if self.watchdog is not None:
            # compile steps don't feed the adaptive deadline: one multi-
            # second XLA compile would slacken it by watchdog_factor x
            self.watchdog.beat(dur_s=None if compiled else dur, step=step)
        if self.sink is not None:
            ev = {'event': 'step', 'kind': self.kind, 'seq': self._n,
                  'dur_s': round(dur, 6),
                  'data_wait_s': round(self._data_wait, 6),
                  'imgs': self.imgs_per_step}
            if step is not None:
                ev['step'] = step
            if self.epoch is not None:
                ev['epoch'] = self.epoch
            if compiled:
                ev['compile'] = True
            self.sink.emit(ev)
        self._data_wait = 0.0

    def interval_stats(self) -> Tuple[float, float]:
        """(imgs/sec, data-wait fraction) over the window since the last
        call, from host wall-clock only; resets the window."""
        now = time.perf_counter()
        wall = now - self._int_t0
        ips = self._int_imgs / wall if wall > 0 else 0.0
        frac = self._int_wait / wall if wall > 0 else 0.0
        self._int_t0 = now
        self._int_wait = 0.0
        self._int_imgs = 0
        return ips, frac
