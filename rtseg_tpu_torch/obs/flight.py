"""Flight recorder: a bounded ring of recent per-request records that is
written out only when something goes wrong (counterpart of
rtseg_tpu/obs/flight.py, the same code: pure stdlib).

Every serving pipeline keeps the last ``capacity`` per-request records
(trace id, status, bucket, per-stage milliseconds) in a preallocated ring,
one small dict store a request. A trigger (``POST /debug/flight`` on the
server, or :func:`dump_all`) writes one ``flight_dump`` event to the event
sink and a ``flight-<source>-<n>-<reason>.jsonl`` snapshot beside the
sink's log, and returns the summary with the records and their
``traffic_mix`` (per bucket: arrival rate, deadline and latency mix).

Recorders register themselves process-wide through weak references, so
one call can dump every plane in the process and a closed pipeline's
recorder simply disappears.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Any, Dict, List, Optional

from .metrics import quantiles_of

#: process-global recorder set for cross-cutting triggers
_RECORDERS: 'weakref.WeakSet' = weakref.WeakSet()
_REG_LOCK = threading.Lock()


def register(recorder: 'FlightRecorder') -> None:
    with _REG_LOCK:
        _RECORDERS.add(recorder)


def dump_all(reason: str) -> List[Dict[str, Any]]:
    """Dump every registered recorder (stall / rollback triggers).
    Best-effort by design: a forensic dump must never take down the
    plane it is documenting."""
    with _REG_LOCK:
        recs = list(_RECORDERS)
    out = []
    for r in recs:
        try:
            out.append(r.dump(reason))
        except Exception as e:   # noqa: BLE001 — never raise into the
            # trigger; the failed dump still leaves a record saying WHICH
            # plane's forensics are missing and why (segfail
            # exception-flow: best-effort must not mean silent)
            out.append({'event': 'flight_dump', 'reason': reason,
                        'source': getattr(r, 'source', '?'),
                        'error': f'{type(e).__name__}: {e}',
                        'records': 0, 'dump_records': []})
    return out


class FlightRecorder:
    """Bounded in-memory ring of per-request records for one plane.

    ``record`` is the hot path: one preallocated ring-slot store under
    the lock — no I/O, no serialization, no growth. ``dump`` copies the
    ring under the lock, then emits/writes entirely OUTSIDE it, so a
    dump in flight never blocks request recording (and never nests the
    recorder lock inside the sink lock).
    """

    def __init__(self, capacity: int = 512, source: str = 'replica'):
        self.source = source
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * max(
            int(capacity), 1)
        self._pos = 0
        self._fill = 0
        self._dumps = 0
        register(self)

    # -------------------------------------------------------------- record
    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring[self._pos] = rec
            self._pos = (self._pos + 1) % len(self._ring)
            if self._fill < len(self._ring):
                self._fill += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        with self._lock:
            if self._fill < len(self._ring):
                return list(self._ring[:self._fill])
            return self._ring[self._pos:] + self._ring[:self._pos]

    def __len__(self) -> int:
        with self._lock:
            return self._fill

    # ---------------------------------------------------------------- dump
    def dump(self, reason: str, sink=None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Snapshot the ring, write the ``flight-<n>-<reason>.jsonl``
        file next to the sink's event log, emit one ``flight_dump``
        event, and return the dump summary (records included) for HTTP
        responses. ``sink`` defaults to the process sink."""
        if sink is None:
            from .core import get_sink
            sink = get_sink()
        records = self.snapshot()
        with self._lock:
            self._dumps += 1
            seq = self._dumps
        mix = traffic_mix(records)
        path = None
        if sink is not None and getattr(sink, 'path', None):
            path = os.path.join(
                os.path.dirname(sink.path),
                f'flight-{self.source}-{seq:03d}-{reason}.jsonl')
            try:
                with open(path, 'w') as f:
                    for rec in records:
                        f.write(json.dumps(rec) + '\n')
            except OSError:
                path = None
        ev = {'event': 'flight_dump', 'reason': reason,
              'source': self.source, 'records': len(records),
              'path': path, 'traffic_mix': mix}
        if extra:
            ev.update(extra)
        if sink is not None:
            sink.emit(ev)
        return {**ev, 'dump_records': records}


def traffic_mix(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Collapse flight records into the replayable traffic shape: per
    bucket, the arrival rate over the ring's span, the deadline mix and
    the e2e latency quantiles."""
    ts = [r['ts'] for r in records if r.get('ts')]
    span_s = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    by_bucket: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        by_bucket.setdefault(str(r.get('bucket')), []).append(r)
    mix: Dict[str, Any] = {'span_s': round(span_s, 3),
                           'total': len(records), 'buckets': {}}
    for bucket, recs in sorted(by_bucket.items()):
        e2e = sorted(float(r['e2e_ms']) for r in recs
                     if r.get('e2e_ms') is not None)
        deadlines = sorted(float(r['deadline_ms']) for r in recs
                           if r.get('deadline_ms') is not None)
        qs = quantiles_of(e2e, (0.5, 0.99))
        mix['buckets'][bucket] = {
            'count': len(recs),
            'share': round(len(recs) / max(len(records), 1), 3),
            'rps': round(len(recs) / span_s, 2) if span_s else None,
            'e2e_p50_ms': qs.get(0.5), 'e2e_p99_ms': qs.get(0.99),
            'deadline_p50_ms': (quantiles_of(deadlines, (0.5,))[0.5]
                                if deadlines else None),
        }
    return mix
