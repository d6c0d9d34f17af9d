"""Stdlib HTTP front end over a ServePipeline (counterpart of
rtseg_tpu/serve/server.py).

ThreadingHTTPServer: one handler thread a connection; handlers block on
their request's Future while the batcher coalesces across them.

API:
  * ``POST /predict`` (or ``/``): the body is a PNG or a JPEG
    (data/image.py decodes it, as PIL does; a corrupt body or another
    format fails with a 500 that says why). 200 is the
    colormapped mask as an RGB PNG (data/png.py encode; ``?raw=1``: the
    int8 class ids as bytes, with ``X-Mask-Shape``). The per-stage
    latency split rides in ``X-Serve-Timing`` as JSON, trace id
    included. 503 = admission rejected (queue full), 504 = deadline
    dropped, 413 = no bucket fits the decoded image.
  * ``GET /healthz``: liveness and lifecycle (``state`` ready or
    draining, ``inflight``, ``drained``).
  * ``POST /drain``: stop admitting (``/predict`` answers 503), let
    in-flight requests finish; ``?exit=1`` also shuts the server down
    once drained. Idempotent.
  * ``GET /stats``: live JSON off the pipeline's metrics registry.
  * ``GET /metrics``: the same registry as Prometheus text, with the
    card's memory watermarks refreshed at each scrape.
  * ``POST /debug/flight``: dump the pipeline's flight recorder to the
    event sink and return the summary, records included.
  * ``POST /debug/profile?ms=N``: a torch.profiler capture of N ms
    (10..5000, default 100) under live traffic (obs/profile.py
    capture_window), answered 200 with the parsed ``profile`` event
    (device busy share, time by category, top ops; the replayed CUDA
    graphs' kernels carry no module), which also goes to the event sink;
    503 with the same body and an ``error`` where the trace lost the
    device work of some launches (``lost_launches``; late in a process's
    life, obs/profile.py), 409 while another capture holds the profiler,
    400 for an ``ms`` that is not a finite number.
    The streaming session plane is not mounted (``stream_config``
    raises, naming ROADMAP.md Queue 1, "The planes").

Every request gets a trace id at ingress (a well-formed inbound
``X-Trace-Id`` is honoured), echoed in the ``X-Trace-Id`` response header
on every response. With a ``replica_id`` every response carries
``X-Replica-Id``; an inbound ``X-Deadline-Ms`` becomes the request's
queue deadline.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..config import not_ported
from ..data import image, png
from ..obs.core import get_sink, update_memory_gauges
from ..obs.metrics import render_prometheus
from ..obs.profile import CaptureBusy, capture_window
from ..obs.tracing import TRACE_KEY, new_trace_id, valid_trace_id
from .batcher import ServeDrop, ServeReject
from .engine import UnknownBucket
from .pipeline import ServePipeline
# the X-* spellings live in serve/headers.py; re-exported here, as the
# JAX package's server does
from .headers import (DEADLINE_HEADER, MASK_DTYPE_HEADER,   # noqa: F401
                      MASK_SHAPE_HEADER, REPLICA_HEADER, STATE_DRAINING,
                      STATE_HEADER, TIMING_HEADER, TRACE_HEADER,
                      VERSION_HEADER)


class ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # absorb open-loop arrival bursts at the TCP layer (socketserver's
    # default listen backlog of 5 resets connections under a spike);
    # overload belongs to the admission 503 path, not the kernel
    request_queue_size = 128

    def __init__(self, addr, pipeline: ServePipeline,
                 colormap: Optional[np.ndarray] = None,
                 request_timeout_s: float = 30.0,
                 replica_id: Optional[str] = None,
                 artifact_version: Optional[str] = None):
        self.pipeline = pipeline
        self.colormap = colormap
        self.request_timeout_s = request_timeout_s
        self.replica_id = replica_id
        self.artifact_version = artifact_version
        self._http_counters: dict = {}
        # drain lifecycle: _draining stops /predict admission, _inflight
        # counts admitted-but-unanswered predicts; both only ever move
        # under _state_lock so /healthz snapshots are consistent
        self._state_lock = threading.Lock()
        self._draining = False
        self._exit_waiter = False
        self._inflight = 0
        #: drain-waiter failures: a drain that dies silently leaves the
        #: process serving 503s forever, so the count is kept
        self.drain_errors = 0
        super().__init__(addr, _Handler)

    # ------------------------------------------------------------ lifecycle
    def try_admit(self) -> bool:
        """One admission token for a /predict: False once draining (the
        handler answers 503), else the in-flight count is incremented —
        the caller must pair it with :meth:`release`."""
        with self._state_lock:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._state_lock:
            self._inflight -= 1

    def begin_drain(self, exit_after: bool = False) -> None:
        """Stop admitting; in-flight requests keep running to completion.
        With ``exit_after`` a waiter thread shuts the accept loop down
        once the last in-flight request has been answered, so the serving
        process can exit with zero dropped work. Idempotent — and a
        plain drain can be upgraded to drain-and-exit by a second call."""
        with self._state_lock:
            self._draining = True
            spawn = exit_after and not self._exit_waiter
            if spawn:
                self._exit_waiter = True
        if spawn:
            threading.Thread(target=self._drain_exit, daemon=True,
                             name='segserve-drain').start()

    def _drain_exit(self) -> None:
        # small grace so the /drain response itself flushes before the
        # accept loop stops; then wait for the in-flight count to hit 0
        time.sleep(0.05)
        while True:
            with self._state_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        try:
            self.shutdown()
        except Exception:   # noqa: BLE001 — accept loop already torn
            # down (e.g. server_close raced us): record, don't die
            # silently in a daemon thread
            with self._state_lock:
                self.drain_errors += 1

    def health(self) -> dict:
        with self._state_lock:
            draining, inflight = self._draining, self._inflight
        out = {'ok': True,
               'state': 'draining' if draining else 'ready',
               'inflight': inflight,
               'drained': draining and inflight == 0}
        if self.replica_id is not None:
            out['replica'] = self.replica_id
        return out

    def count_response(self, code: int) -> None:
        c = self._http_counters.get(code)
        if c is None:
            # get-or-create is idempotent: a racing first response for the
            # same code resolves to the same registry counter, and the
            # last-write-wins dict store caches that same object: the
            # check-then-act window loses no increments (a harmless
            # race)
            c = self.pipeline.registry.counter(
                'serve_http_responses_total',
                help='HTTP responses by status code', code=str(code))
            self._http_counters[code] = c
        c.inc()


class _Handler(BaseHTTPRequestHandler):
    server: ServeHTTPServer
    protocol_version = 'HTTP/1.1'

    def log_message(self, *args) -> None:   # quiet: telemetry goes to obs
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              extra: Optional[dict] = None) -> None:
        self.server.count_response(code)
        self.send_response(code)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        if self.server.replica_id is not None:
            # every response — success or error — attributes itself, so
            # the load-gen report and the router can count per replica
            self.send_header(REPLICA_HEADER, self.server.replica_id)
        if self.server.artifact_version is not None:
            # ...and to the artifact version it serves
            self.send_header(VERSION_HEADER, self.server.artifact_version)
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj,
                   extra: Optional[dict] = None) -> None:
        self._send(code, json.dumps(obj).encode(), 'application/json',
                   extra)

    def do_GET(self) -> None:   # noqa: N802 — http.server API
        path = self.path.split('?', 1)[0]
        if path == '/healthz':
            self._send_json(200, self.server.health())
        elif path == '/stats':
            update_memory_gauges(self.server.pipeline.registry)
            self._send_json(200, self.server.pipeline.stats())
        elif path == '/metrics':
            # refresh the device memory watermarks at scrape time so
            # peak HBM is current, not an epoch/capture stale-read
            update_memory_gauges(self.server.pipeline.registry)
            text = render_prometheus(self.server.pipeline.registry)
            self._send(200, text.encode(),
                       'text/plain; version=0.0.4; charset=utf-8')
        else:
            self._send_json(404, {'error': f'no route {path}'})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        # consume the body BEFORE any reply: under HTTP/1.1 keep-alive an
        # unread body would be parsed as the next request line,
        # desyncing the connection
        length = int(self.headers.get('Content-Length', 0))
        data = self.rfile.read(length) if length > 0 else b''
        path = self.path.split('?', 1)[0]
        # HTTP ingress is where the trace id is born: honor a well-formed
        # inbound X-Trace-Id (upstream caller stitching its own trace),
        # mint otherwise. Every response — success or error — echoes it.
        inbound = self.headers.get(TRACE_HEADER)
        tid = inbound if valid_trace_id(inbound) else new_trace_id()
        trace_hdr = {TRACE_HEADER: tid}
        if path == '/debug/profile':
            self._debug_profile(trace_hdr)
            return
        if path == '/debug/flight':
            self._debug_flight(data, trace_hdr)
            return
        if path == '/drain':
            query = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)
            exit_after = query.get('exit', ['0'])[0] not in ('0', '',
                                                             'false')
            self.server.begin_drain(exit_after=exit_after)
            self._send_json(200, self.server.health(), trace_hdr)
            return
        if path not in ('/', '/predict'):
            self._send_json(404, {'error': f'no route {path}'},
                            trace_hdr)
            return
        if not data:
            self._send_json(400, {'error': 'empty body'}, trace_hdr)
            return
        # deadline propagation: an upstream router hands down its
        # remaining latency budget; it becomes this request's queue
        # deadline so fleet-level 504 semantics hold end to end
        deadline_ms = None
        dl_raw = self.headers.get(DEADLINE_HEADER)
        if dl_raw is not None:
            try:
                deadline_ms = float(dl_raw)
            except ValueError:
                deadline_ms = float('nan')
            if not math.isfinite(deadline_ms):
                self._send_json(400, {'error': f'{DEADLINE_HEADER} must '
                                               f'be a finite number'},
                                trace_hdr)
                return
            if deadline_ms <= 0:
                self._send_json(504, {'error': 'deadline already '
                                               'expired at ingress'},
                                trace_hdr)
                return
        if not self.server.try_admit():
            # the X-Replica-State header lets a fleet router distinguish
            # this 503 (lifecycle: replica chosen before the drain state
            # propagated — safe to retry elsewhere, never entered the
            # pipeline so no serve_requests_total entry) from the
            # batcher's queue-full 503 (backpressure: must surface)
            self._send_json(503, {'error': 'replica draining'},
                            {**trace_hdr,
                             STATE_HEADER: STATE_DRAINING})
            return
        try:
            self._predict(data, deadline_ms, tid, trace_hdr)
        finally:
            self.server.release()

    def _predict(self, data: bytes, deadline_ms: Optional[float],
                 tid: str, trace_hdr: dict) -> None:
        try:
            fut = self.server.pipeline.submit_bytes(
                data, deadline_ms=deadline_ms, meta={TRACE_KEY: tid})
            res = fut.result(timeout=self.server.request_timeout_s)
        except ServeReject as e:
            self._send_json(503, {'error': str(e)}, trace_hdr)
            return
        except ServeDrop as e:
            self._send_json(504, {'error': str(e)}, trace_hdr)
            return
        except UnknownBucket as e:
            self._send_json(413, {'error': str(e)}, trace_hdr)
            return
        except (TimeoutError, concurrent.futures.TimeoutError):
            # both spellings: futures.TimeoutError only aliases the
            # builtin from Python 3.11
            self._send_json(504, {'error': 'server-side wait timed out'},
                            trace_hdr)
            return
        except Exception as e:   # noqa: BLE001 — surface, don't hang
            self._send_json(500, {'error': f'{type(e).__name__}: {e}'},
                            trace_hdr)
            return
        timing = json.dumps({TRACE_KEY: tid,
                             **{k: round(v, 3)
                                for k, v in res.timings.items()}})
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        if query.get('raw', ['0'])[0] not in ('0', '', 'false'):
            h, w = res.mask.shape
            self._send(200, np.ascontiguousarray(res.mask).tobytes(),
                       'application/octet-stream',
                       {MASK_SHAPE_HEADER: f'{h},{w}',
                        MASK_DTYPE_HEADER: 'int8',
                        TIMING_HEADER: timing, **trace_hdr})
            return
        cmap = self.server.colormap
        if cmap is None:
            self._send_json(500, {'error': 'server has no colormap; '
                                           'use ?raw=1'}, trace_hdr)
            return
        self._send(200, png.encode(cmap[res.mask]), 'image/png',
                   {TIMING_HEADER: timing, **trace_hdr})

    def _debug_flight(self, data: bytes, trace_hdr: dict) -> None:
        """Flight-recorder trigger (obs/flight.py): dump the pipeline's
        ring of recent per-request records to the sink and return the
        summary, records included, as JSON. The body may carry
        ``{"reason": ...}`` to label the dump. Passive: requests keep
        flowing; the dump happens outside the recorder lock."""
        reason = 'manual'
        if data:
            try:
                reason = str(json.loads(data.decode()).get(
                    'reason', 'manual'))
            except (ValueError, AttributeError):
                pass
        try:
            out = self.server.pipeline.flight.dump(reason)
        except Exception as e:   # noqa: BLE001 — surface, don't hang
            self._send_json(500, {'error': f'{type(e).__name__}: {e}'},
                            trace_hdr)
            return
        self._send_json(200, out, trace_hdr)

    def _debug_profile(self, trace_hdr: dict) -> None:
        """On-demand capture under live traffic (obs/profile.py
        capture_window): trace for ?ms= of wall clock, return the parsed
        breakdown as JSON. One capture at a time (409 when busy), the
        duration bounded so a mistyped request cannot trace for
        minutes."""
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        try:
            ms = float(query.get('ms', ['100'])[0])
        except ValueError:
            ms = float('nan')
        if not math.isfinite(ms):
            # NaN slips through the clamp below (its comparisons are
            # False) and would serialize as invalid JSON
            self._send_json(400, {'error': 'ms must be a finite number'},
                            trace_hdr)
            return
        ms = min(max(ms, 10.0), 5000.0)
        reg = self.server.pipeline.registry
        try:
            prof = capture_window(ms / 1e3)
        except CaptureBusy as e:
            self._send_json(409, {'error': str(e)}, trace_hdr)
            return
        except Exception as e:   # noqa: BLE001 — surface, don't hang
            self._send_json(500, {'error': f'{type(e).__name__}: {e}'},
                            trace_hdr)
            return
        # the live-plane metrics the sampled profiler feeds, so a /metrics
        # scrape reconciles with this response's busy_frac; an incomplete
        # profile's busy share is wrong and leaves the gauge alone
        reg.counter('profile_captures_total',
                    help='sampled/on-demand profile captures '
                         'completed').inc()
        if prof.complete:
            reg.gauge('device_busy_frac',
                      help='device busy fraction of the last profile '
                           'capture').set(prof.busy_frac)
        update_memory_gauges(reg)
        ev = prof.to_event(source='debug', requested_ms=ms)
        sink = get_sink()
        if sink is not None:
            sink.emit(ev)
        if prof.complete:
            self._send_json(200, ev, trace_hdr)
            return
        self._send_json(503, dict(ev, error=(
            f'the trace lost the device work of {prof.lost_launches} '
            f'launches: this profile is incomplete (a capture from another '
            f'thread late in the process; ROADMAP.md Queue 3)')), trace_hdr)


def make_server(pipeline: ServePipeline, host: str = '127.0.0.1',
                port: int = 8080, colormap: Optional[np.ndarray] = None,
                request_timeout_s: float = 30.0,
                replica_id: Optional[str] = None,
                artifact_version: Optional[str] = None,
                stream_config=None) -> ServeHTTPServer:
    """Bind (port 0 picks a free one; read ``server.server_address``).
    Call ``serve_forever()`` (typically on a thread), then ``shutdown()``
    and ``pipeline.close()``. ``stream_config`` (the streaming session
    plane) raises: not ported yet."""
    if stream_config is not None:
        raise not_ported('the streaming session plane (stream/)',
                         'The planes')
    return ServeHTTPServer((host, port), pipeline, colormap=colormap,
                           request_timeout_s=request_timeout_s,
                           replica_id=replica_id,
                           artifact_version=artifact_version)


def make_preprocess(config):
    """bytes -> preprocessed (h, w, 3) f32 image: a PNG or a JPEG decoded
    by data/image.py, then the EvalTransform the validation path uses
    (data/transforms.py). Other formats raise NotImplementedError."""
    from ..data.transforms import EvalTransform
    transform = EvalTransform(config)

    def preprocess(data: bytes) -> np.ndarray:
        return transform(image.decode(data, 'RGB', 'the request body'),
                         None, None)

    return preprocess
