"""Async serving pipeline: preprocess pool -> batcher -> card -> post pool
(counterpart of rtseg_tpu/serve/pipeline.py, the same stages and policy).

  * **preprocess**: a thread pool decodes and normalizes request bytes
    (data/png.py, whose row unfilter runs in native/host.c through ctypes
    and releases the GIL, and the EvalTransform), never on the dispatch
    path;
  * **dispatch**: one thread pulls coalesced batches from the
    MicroBatcher, pads them to the bucket (engine.assemble_batch) and
    replays the bucket's CUDA graph (engine.dispatch), which returns at
    once with a handle;
  * **readback**: one thread waits on each handle's event (the batch's
    own int8 copy into a pinned slot, never the whole device) and fans
    the rows out to the postprocess pool. Dispatch and readback talk
    through a queue ``inflight`` deep (2), so one batch computes while
    the next is assembled and dispatched, and the bound keeps queueing on
    the card from hiding overload from the admission check;
  * **postprocess**: a thread pool crops each mask to its request's
    (h, w) and runs the optional ``postprocess`` hook (colormap and PNG
    encode for the HTTP front end).

Each request's time splits into queue / assemble / device / post (and
decode), emitted as one ``request`` event with its trace id, fed to the
pipeline's MetricsRegistry (ok/error counters, per-stage histograms; what
``GET /metrics``, ``/stats`` and ``stats()`` read) and recorded in the
flight recorder.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..obs import get_sink, span
from ..obs.flight import FlightRecorder
from ..obs.metrics import MetricsRegistry
from ..obs.tracing import TRACE_KEY
from .batcher import MicroBatcher, Request, _bucket_str
from .engine import ServeEngine, assemble_batch

_DONE = object()


@dataclass
class ServeResult:
    """What a request's Future resolves to."""
    mask: np.ndarray                      # (h, w) int8, cropped
    timings: Dict[str, float]             # per-stage milliseconds
    payload: Any = None                   # postprocess() output, if any
    meta: Dict[str, Any] = field(default_factory=dict)


class ServePipeline:
    """Owns the batcher and the stage threads around a ServeEngine."""

    def __init__(self, engine: ServeEngine,
                 max_wait_ms: float = 5.0, max_queue: int = 128,
                 deadline_ms: Optional[float] = None,
                 preprocess: Optional[Callable[[bytes], np.ndarray]] = None,
                 postprocess: Optional[Callable[[np.ndarray, Request],
                                                Any]] = None,
                 pre_workers: int = 2, post_workers: int = 2,
                 inflight: int = 2,
                 registry: Optional[MetricsRegistry] = None,
                 trace: bool = True):
        self.engine = engine
        self.preprocess = preprocess
        self.postprocess = postprocess
        # one registry per pipeline (unless the caller shares one): the
        # batcher's admission counters and the per-stage histograms below
        # land in the same object, which is what GET /metrics renders
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        reg = self.registry
        self._c_ok = reg.counter('serve_requests_total', status='ok')
        self._c_error = reg.counter('serve_requests_total',
                                    status='error')
        self._h_e2e = reg.histogram(
            'serve_request_e2e_ms', exemplars=8,
            help='end-to-end request latency, ingress to response (ms)')
        self._h_stage = {
            stage: reg.histogram('serve_stage_ms', stage=stage)
            for stage in ('assemble', 'device', 'post', 'decode')}
        self._g_inflight = reg.gauge(
            'serve_inflight_batches',
            help='batches dispatched to device, not yet read back')
        # flight recorder: the last per-request records, dumped only
        # on a trigger (obs/flight.py)
        self.flight = FlightRecorder(source='replica')
        self.batcher = MicroBatcher(engine.buckets, engine.batch,
                                    max_wait_ms=max_wait_ms,
                                    max_queue=max_queue,
                                    deadline_ms=deadline_ms,
                                    registry=reg, trace=trace)
        self._pre = ThreadPoolExecutor(max_workers=max(1, pre_workers),
                                       thread_name_prefix='segserve-pre')
        self._post = ThreadPoolExecutor(max_workers=max(1, post_workers),
                                        thread_name_prefix='segserve-post')
        self._inflight: queue.Queue = queue.Queue(maxsize=max(1, inflight))
        self._closing = False
        self._closed = False
        self.error: Optional[BaseException] = None
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name='segserve-dispatch')
        self._reader = threading.Thread(
            target=self._readback_loop, daemon=True,
            name='segserve-readback')
        self._dispatcher.start()
        self._reader.start()

    # ------------------------------------------------------------- ingress
    def submit(self, image: np.ndarray,
               deadline_ms: Optional[float] = None,
               meta: Optional[Dict[str, Any]] = None) -> Future:
        """Admit one already-preprocessed (h, w, 3) f32 image."""
        if self.error is not None:
            raise RuntimeError('serve pipeline is dead') from self.error
        return self.batcher.submit(image, deadline_ms=deadline_ms,
                                   meta=meta)

    def submit_bytes(self, data: bytes,
                     deadline_ms: Optional[float] = None,
                     meta: Optional[Dict[str, Any]] = None) -> Future:
        """Admit raw request bytes; decode/normalize runs on the
        preprocess pool, then the result chains into :meth:`submit`. The
        returned Future resolves to the same ServeResult (with a
        ``decode_ms`` timing added) or raises the admission error."""
        if self.preprocess is None:
            raise RuntimeError('pipeline built without a preprocess fn')
        outer: Future = Future()
        t_recv = time.perf_counter()

        def _chain(inner: Future) -> None:
            try:
                outer.set_result(inner.result())
            except BaseException as e:   # noqa: BLE001 — mirror verbatim
                outer.set_exception(e)

        def _decode() -> None:
            try:
                with span('serve/decode', record=False):
                    image = self.preprocess(data)
                m = dict(meta or {})
                m['t_recv'] = t_recv
                m['decode_ms'] = (time.perf_counter() - t_recv) * 1e3
                inner = self.submit(image, deadline_ms=deadline_ms, meta=m)
            except BaseException as e:   # noqa: BLE001 — mirror verbatim
                outer.set_exception(e)
                return
            inner.add_done_callback(_chain)

        self._pre.submit(_decode)
        return outer

    # -------------------------------------------------------------- stages
    def _dispatch_loop(self) -> None:
        # the whole loop runs under one broad shield: a dispatcher that
        # dies silently (get_batch raising, not just the engine) wedges
        # every client forever, so any escape poisons the pipeline and
        # fails pending work
        try:
            while True:
                got = self.batcher.get_batch(timeout=0.05)
                if got is None:
                    if self._closing:
                        break
                    continue
                bucket, reqs = got
                try:
                    with span('serve/assemble', record=False):
                        arr = assemble_batch([r.image for r in reqs],
                                             bucket, self.engine.batch)
                    t_d0 = time.perf_counter()
                    with span('serve/dispatch', record=False):
                        dev = self.engine.dispatch(bucket, arr)
                    t_d1 = time.perf_counter()
                except BaseException as e:  # noqa: BLE001 — engine dead
                    self.error = e
                    # every admitted request must reach a terminal
                    # serve_requests_total status — this batch errors
                    # here, the still-queued ones inside fail_all
                    self._c_error.inc(len(reqs))
                    for r in reqs:
                        r.future.set_exception(e)
                    self.batcher.close()
                    self.batcher.fail_all(e)
                    break
                self._inflight.put((bucket, reqs, t_d0, t_d1, dev))
                self._g_inflight.set(self._inflight.qsize())
        except BaseException as e:   # noqa: BLE001 — loop itself died
            self.error = e
            self._c_error.inc()
            try:
                self.batcher.close()
                self.batcher.fail_all(e)
            except Exception:   # noqa: BLE001 — cleanup is best-effort
                self._c_error.inc()
        self._inflight.put(_DONE)

    def _readback_loop(self) -> None:
        try:
            while True:
                item = self._inflight.get()
                if item is _DONE:
                    break
                self._g_inflight.set(self._inflight.qsize())
                bucket, reqs, t_d0, t_d1, dev = item
                try:
                    with span('serve/readback', record=False):
                        host = dev.result()
                except BaseException as e:  # noqa: BLE001 — async
                    # dispatch: CUDA errors of a replay surface at the
                    # wait on its event, i.e. HERE, not at the dispatch
                    # call; resolve this batch's futures instead of
                    # letting the thread die and wedge the pipeline
                    self._c_error.inc(len(reqs))
                    for r in reqs:
                        r.future.set_exception(e)
                    continue
                t_done = time.perf_counter()
                for i, r in enumerate(reqs):
                    self._post.submit(self._finish, r, host[i], t_d1,
                                      t_done)
        except BaseException as e:   # noqa: BLE001 — reader died (e.g.
            # post-pool submit after shutdown): poison the pipeline so
            # submit() raises instead of hanging clients silently
            self.error = e
            self._c_error.inc()

    def _finish(self, r: Request, row: np.ndarray, t_disp: float,
                t_done: float) -> None:
        h, w = r.hw
        mask = row[:h, :w]
        payload = None
        try:
            if self.postprocess is not None:
                with span('serve/post', record=False):
                    payload = self.postprocess(mask, r)
        except BaseException as e:   # noqa: BLE001 — per-request failure
            self._c_error.inc()
            r.future.set_exception(e)
            return
        t_end = time.perf_counter()
        t0 = r.meta.get('t_recv', r.t_submit)
        timings = {
            'queue_ms': (r.t_popped - r.t_submit) * 1e3,
            'assemble_ms': (t_disp - r.t_popped) * 1e3,
            'device_ms': (t_done - t_disp) * 1e3,
            'post_ms': (t_end - t_done) * 1e3,
            'e2e_ms': (t_end - t0) * 1e3,
        }
        if 'decode_ms' in r.meta:
            timings['decode_ms'] = r.meta['decode_ms']
        self._c_ok.inc()
        self._h_e2e.observe(timings['e2e_ms'],
                            exemplar=r.meta.get(TRACE_KEY))
        for stage, h in self._h_stage.items():
            key = stage + '_ms'
            if key in timings:
                h.observe(timings[key])
        rec = {'ts': time.time(), 'status': 'ok',
               'bucket': _bucket_str(r.bucket),
               'deadline_ms': ((r.deadline - r.t_submit) * 1e3
                               if r.deadline is not None else None),
               **{k: round(v, 3) for k, v in timings.items()}}
        if TRACE_KEY in r.meta:
            rec[TRACE_KEY] = r.meta[TRACE_KEY]
        self.flight.record(rec)
        sink = get_sink()
        if sink is not None:
            ev = {'event': 'request', 'status': 'ok',
                  'bucket': _bucket_str(r.bucket),
                  **{k: round(v, 3) for k, v in timings.items()}}
            if TRACE_KEY in r.meta:
                ev[TRACE_KEY] = r.meta[TRACE_KEY]
            sink.emit(ev)
        r.future.set_result(ServeResult(mask=mask, timings=timings,
                                        meta=r.meta))

    # ------------------------------------------------------------ lifetime
    def close(self) -> None:
        """Drain queued requests, stop the stage threads, shut the pools
        down. Idempotent."""
        if self._closed:
            return
        self._closing = True
        self.batcher.close()
        self._dispatcher.join(timeout=60)
        self._reader.join(timeout=60)
        self._post.shutdown(wait=True)
        self._pre.shutdown(wait=True)
        self._closed = True

    def __enter__(self) -> 'ServePipeline':
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Live counters, read straight from the metrics registry — the
        same objects ``GET /metrics`` renders, so the JSON and Prometheus
        views of this pipeline cannot disagree."""
        snap = self._h_e2e.snapshot()   # one sort: quantiles + exemplars
        qs = snap['quantiles']
        return {
            'ok': self._c_ok.value,
            'errors': self._c_error.value,
            'request_ms': {'count': snap['count'],
                           'p50': qs.get(0.5), 'p95': qs.get(0.95),
                           'p99': qs.get(0.99)},
            'exemplars': snap.get('exemplars', []),
            'batcher': self.batcher.stats(),
            'engine': self.engine.stats(),
            'inflight': self._inflight.qsize(),
            'dead': self.error is not None,
        }
