"""Dynamic micro-batcher (counterpart of rtseg_tpu/serve/batcher.py, the
same host code and policy): a bounded request queue that coalesces
requests into bucket-homogeneous batches under a max_batch / max_wait_ms
policy.

  * **overload**: admission is rejected (ServeReject) when the queue is
    full, so overload surfaces as fast 503s at the edge instead of a
    queue whose wait grows without bound;
  * **stale work**: a request may carry a deadline; a request whose
    deadline passed while it waited is dropped (ServeDrop) at dequeue
    time rather than occupying a batch slot;
  * **head-of-line blocking across shapes**: one FIFO a bucket; the
    consumer always serves the bucket whose head request is oldest.

Every admission emits an ``ingress`` event, every batch a ``batch`` event
and every terminal outcome a ``request`` event into the process-global
event sink (obs/core.py), each with the request's trace id (minted here
when no ingress minted one). The admission counters live in a
MetricsRegistry (obs/metrics.py) shared with the owning pipeline, so
``stats()``, ``/stats`` and ``GET /metrics`` read the same objects.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import get_sink
from ..obs.metrics import MetricsRegistry
from ..obs.tracing import TRACE_KEY, ensure_trace
from .engine import Bucket, UnknownBucket, select_bucket


class ServeReject(RuntimeError):
    """Admission rejected: the request queue is full (backpressure)."""


class ServeDrop(RuntimeError):
    """Request dropped: its deadline passed while it waited in queue."""


@dataclass
class Request:
    image: np.ndarray                     # (h, w, 3) f32, preprocessed
    hw: Tuple[int, int]
    bucket: Bucket
    future: Future
    t_submit: float                       # perf_counter at admission
    deadline: Optional[float] = None      # absolute perf_counter deadline
    t_popped: Optional[float] = None      # perf_counter at batch assembly
    meta: Dict[str, Any] = field(default_factory=dict)


def _bucket_str(b: Bucket) -> str:
    return f'{b[0]}x{b[1]}'


class MicroBatcher:
    """Thread-safe bounded queue with per-bucket coalescing.

    Producers call :meth:`submit` (any thread); one consumer loop calls
    :meth:`get_batch`. A batch is released when its bucket holds
    ``max_batch`` requests, or when the bucket's oldest request has waited
    ``max_wait_ms`` — latency-bounded coalescing, not full-batch-or-bust.
    """

    def __init__(self, buckets: Sequence[Bucket], max_batch: int,
                 max_wait_ms: float = 5.0, max_queue: int = 128,
                 deadline_ms: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 trace: bool = True):
        self.buckets = sorted({tuple(b) for b in buckets})
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.deadline_ms = deadline_ms
        self.trace = trace
        # bounded by admission, not by the deque: submit() rejects once
        # the TOTAL queued count across buckets hits max_queue (under
        # _cond), so no per-bucket maxlen exists that wouldn't silently
        # drop admitted requests — justified segfail suppression
        self._queues: Dict[Bucket, deque] = {b: deque()
                                             for b in self.buckets}
        self._cond = threading.Condition()
        self._closed = False
        # registry-backed counters: one source of truth for stats(),
        # /stats and /metrics. A private registry per batcher unless the
        # owning pipeline shares its own.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        reg = self.registry
        self._c_submitted = reg.counter(
            'serve_admitted_total',
            help='requests admitted into the queue (resolve later as a '
                 'terminal serve_requests_total status)')
        self._c_rejected = reg.counter(
            'serve_requests_total',
            help='terminal request outcomes by status', status='rejected')
        self._c_dropped = reg.counter('serve_requests_total',
                                      status='dropped')
        self._c_error = reg.counter('serve_requests_total',
                                    status='error')
        self._c_batches = reg.counter(
            'serve_batches_total', help='coalesced batches dispatched')
        self._c_batched = reg.counter(
            'serve_batched_requests_total',
            help='requests that occupied a real batch slot')
        self._c_padded = reg.counter(
            'serve_padded_slots_total',
            help='batch slots shipped as padding (1 - occupancy)')
        self._g_depth = reg.gauge(
            'serve_queue_depth', help='requests currently queued across '
            'all buckets')
        self._h_queue = reg.histogram(
            'serve_stage_ms', help='per-stage request latency (ms)',
            stage='queue')

    # ------------------------------------------------------------ producer
    def submit(self, image: np.ndarray,
               deadline_ms: Optional[float] = None,
               meta: Optional[Dict[str, Any]] = None) -> Future:
        """Admit one preprocessed image; returns a Future resolving to the
        consumer-side result. Raises UnknownBucket when no bucket fits and
        ServeReject when the queue is full or the batcher is closed."""
        h, w = int(image.shape[0]), int(image.shape[1])
        bucket = select_bucket(self.buckets, h, w)
        if bucket is None:
            raise UnknownBucket(
                f'no bucket fits {h}x{w}; configured: '
                + ','.join(_bucket_str(b) for b in self.buckets))
        now = time.perf_counter()
        dl_ms = self.deadline_ms if deadline_ms is None else deadline_ms
        m = dict(meta or {})
        if self.trace:
            # trace id: minted here unless HTTP ingress / the load-gen
            # already did — one id per request, whatever the entry point
            ensure_trace(m)
        req = Request(
            image=image, hw=(h, w), bucket=bucket, future=Future(),
            t_submit=now,
            deadline=(now + dl_ms / 1e3) if dl_ms is not None else None,
            meta=m)
        with self._cond:
            if self._closed:
                raise ServeReject('batcher is closed')
            depth = sum(len(q) for q in self._queues.values())
            if depth < self.max_queue:
                self._queues[bucket].append(req)
                # gauge write stays INSIDE the lock: it is order-
                # sensitive (a stale post-lock write would overwrite the
                # consumer's pop) and lock-cheap, unlike the event I/O
                self._g_depth.set(depth + 1)
                self._cond.notify_all()
        # counter updates + event emission (file write + flush) stay off
        # the condition lock: every admitting thread would otherwise
        # serialize on disk latency
        if depth >= self.max_queue:
            self._c_rejected.inc()
            self._emit_request(req, 'rejected', now)
            raise ServeReject(
                f'queue full ({depth}/{self.max_queue}); retry later')
        self._c_submitted.inc()
        if self.trace:
            # the ingress event exists to anchor the trace timeline; with
            # tracing off there is no id to anchor, so no event either
            self._emit_ingress(req)
        return req.future

    # ------------------------------------------------------------ consumer
    def get_batch(self, timeout: Optional[float] = None
                  ) -> Optional[Tuple[Bucket, List[Request]]]:
        """Block until a batch is ready (or ``timeout`` elapses / the
        batcher is closed and drained — both return None). Expired
        requests are dropped here, at dequeue time. Queue state changes
        happen under the lock (_poll_locked); event emission and future
        resolution — file I/O and arbitrary done-callbacks — happen
        outside it."""
        overall = (time.perf_counter() + timeout) if timeout is not None \
            else None
        while True:
            dropped, batch, done = self._poll_locked(overall)
            now = time.perf_counter()
            if dropped:
                self._c_dropped.inc(len(dropped))
            for r in dropped:
                self._emit_request(r, 'dropped', now)
                r.future.set_exception(ServeDrop(
                    f'deadline exceeded after '
                    f'{(now - r.t_submit) * 1e3:.1f} ms in queue'))
            if batch is not None:
                bucket, reqs, head_age_ms = batch
                self._c_batches.inc()
                self._c_batched.inc(len(reqs))
                self._c_padded.inc(self.max_batch - len(reqs))
                for r in reqs:
                    self._h_queue.observe((r.t_popped - r.t_submit) * 1e3)
                self._emit_batch(bucket, reqs, head_age_ms)
                return bucket, reqs
            if done:
                return None

    def _poll_locked(self, overall: Optional[float]):
        """One scheduling step under the lock: pop expired requests,
        release a ready batch, or wait. Returns (dropped_requests,
        (bucket, requests, head_age_ms) | None, exhausted)."""
        with self._cond:
            now = time.perf_counter()
            dropped: List[Request] = []
            for q in self._queues.values():
                while q and q[0].deadline is not None \
                        and now > q[0].deadline:
                    dropped.append(q.popleft())
            if dropped:
                self._g_depth.set(sum(len(q)
                                      for q in self._queues.values()))
            bucket = self._oldest_bucket_locked()
            if bucket is None:
                if dropped:
                    # flush the drops before blocking again
                    return dropped, None, False
                if self._closed or (overall is not None
                                    and now >= overall):
                    return dropped, None, True
                self._cond.wait(
                    None if overall is None else overall - now)
                return dropped, None, False
            q = self._queues[bucket]
            head_age_ms = (now - q[0].t_submit) * 1e3
            if (len(q) >= self.max_batch or self._closed
                    or head_age_ms >= self.max_wait_ms):
                reqs = [q.popleft()
                        for _ in range(min(self.max_batch, len(q)))]
                for r in reqs:
                    r.t_popped = now
                self._g_depth.set(sum(len(qq)
                                      for qq in self._queues.values()))
                return dropped, (bucket, reqs, head_age_ms), False
            # sleep until the head ages out, a notify, or the timeout
            wait_s = (self.max_wait_ms - head_age_ms) / 1e3
            if overall is not None:
                wait_s = min(wait_s, overall - now)
            self._cond.wait(max(wait_s, 1e-4))
            return dropped, None, False

    def close(self) -> None:
        """Stop admissions; queued requests still drain via get_batch."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail_all(self, exc: BaseException) -> None:
        """Resolve every queued request with ``exc`` (engine teardown).
        The requests reach their terminal ``error`` status in the
        registry, so admitted-vs-terminal accounting stays exact even
        through a teardown."""
        with self._cond:
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._g_depth.set(0)
            self._cond.notify_all()
        if pending:
            self._c_error.inc(len(pending))
        for r in pending:
            r.future.set_exception(exc)

    # ------------------------------------------------------------ internal
    def _oldest_bucket_locked(self) -> Optional[Bucket]:
        best, best_t = None, None
        for b, q in self._queues.items():
            if q and (best_t is None or q[0].t_submit < best_t):
                best, best_t = b, q[0].t_submit
        return best

    def _emit_ingress(self, req: Request) -> None:
        sink = get_sink()
        if sink is not None:
            ev = {'event': 'ingress', 'bucket': _bucket_str(req.bucket)}
            if TRACE_KEY in req.meta:
                ev[TRACE_KEY] = req.meta[TRACE_KEY]
            sink.emit(ev)

    def _emit_request(self, req: Request, status: str, now: float) -> None:
        sink = get_sink()
        if sink is not None:
            ev = {'event': 'request', 'status': status,
                  'bucket': _bucket_str(req.bucket),
                  'queue_ms': round((now - req.t_submit) * 1e3, 3)}
            if TRACE_KEY in req.meta:
                ev[TRACE_KEY] = req.meta[TRACE_KEY]
            sink.emit(ev)

    def _emit_batch(self, bucket: Bucket, reqs: List[Request],
                    head_age_ms: float) -> None:
        sink = get_sink()
        if sink is not None:
            ev = {'event': 'batch', 'bucket': _bucket_str(bucket),
                  'size': len(reqs), 'cap': self.max_batch,
                  'wait_ms': round(head_age_ms, 3)}
            traces = [r.meta[TRACE_KEY] for r in reqs
                      if TRACE_KEY in r.meta]
            if traces:
                ev['traces'] = traces
            sink.emit(ev)

    # registry-backed counters exposed under their historical names, so
    # stats() callers and the in-process API read the exact objects
    # /metrics renders
    @property
    def submitted(self) -> int:
        return self._c_submitted.value

    @property
    def rejected(self) -> int:
        return self._c_rejected.value

    @property
    def dropped(self) -> int:
        return self._c_dropped.value

    @property
    def batches(self) -> int:
        return self._c_batches.value

    @property
    def batched_requests(self) -> int:
        return self._c_batched.value

    @property
    def padded_slots(self) -> int:
        return self._c_padded.value

    def stats(self) -> dict:
        with self._cond:
            depth = sum(len(q) for q in self._queues.values())
        return {
            'submitted': self.submitted,
            'rejected': self.rejected,
            'dropped': self.dropped,
            'batches': self.batches,
            'batched_requests': self.batched_requests,
            'padded_slots': self.padded_slots,
            'depth': depth,
            'max_queue': self.max_queue,
            'max_batch': self.max_batch,
            'max_wait_ms': self.max_wait_ms,
        }
