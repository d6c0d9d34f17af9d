"""Spans and the JSONL event sink (counterpart of rtseg_tpu/obs/core.py:
the parts serving and prediction use).

A *span* times a host region: it emits ``{"event": "span", "name", "ts",
"dur_s", "depth"}`` to the process-global :class:`EventSink` (one JSONL
file under the run's directory) and mirrors the name into an active
torch.profiler trace through ``torch.profiler.record_function``, where the
JAX package uses ``jax.profiler.TraceAnnotation``. Device memory
watermarks come from ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

import torch


class EventSink:
    """Append-only JSONL event writer.

    Thread-safe without a lock on the write path: the file is opened
    ``O_APPEND`` and each event goes down as one ``os.write``, which POSIX
    makes atomic, so concurrent emitters never interleave lines and never
    wait on each other's disk latency. One unbuffered write a line also
    means a crash cannot eat the events that explain it.

    Each event gets a wall-clock ``ts`` and the sink's static fields
    (``host``) unless the caller set them. Emitting into a closed sink is
    a silent no-op counted in ``dropped``, so late telemetry racing a
    shutdown never raises.
    """

    def __init__(self, path: str, static: Optional[Dict[str, Any]] = None):
        self.path = path
        self.static = dict(static or {})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._closed = False
        #: emits lost to the close race (best-effort count)
        self.dropped = 0

    def emit(self, event: Dict[str, Any]) -> None:
        if self._closed:
            return
        rec = dict(self.static)
        rec.update(event)
        rec.setdefault('ts', time.time())
        data = (json.dumps(rec, default=str) + '\n').encode()
        try:
            os.write(self._fd, data)
        except OSError:
            # lost the race with close(): the fd was swapped to -1 between
            # the _closed check and the write; drop the line and count it
            self.dropped += 1

    def close(self) -> None:
        """Idempotent. The fd is swapped out before it is released, so a
        concurrent emit sees -1 (EBADF, counted) rather than writing into
        a recycled descriptor."""
        self._closed = True
        fd, self._fd = self._fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                self.dropped += 1


# process-global sink: the entry point owns its lifecycle (init_run /
# set_sink); library code emits through get_sink() and does nothing when
# telemetry is off
_SINK: Optional[EventSink] = None
_TLS = threading.local()                    # per-thread span nesting depth


def set_sink(sink: Optional[EventSink]) -> None:
    global _SINK
    _SINK = sink


def get_sink() -> Optional[EventSink]:
    return _SINK


@contextmanager
def span(name: str, record: bool = True, **attrs: Any) -> Iterator[None]:
    """Time a host region. ``record=True`` emits a ``span`` event on exit
    (when a sink is set); ``record=False`` only labels the region in a
    profiler trace, for regions a richer event already times."""
    depth = getattr(_TLS, 'depth', 0)
    _TLS.depth = depth + 1
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dur = time.perf_counter() - t0
        _TLS.depth = depth
        sink = _SINK
        if record and sink is not None:
            ev: Dict[str, Any] = {'event': 'span', 'name': name,
                                  'dur_s': round(dur, 6), 'depth': depth}
            if attrs:
                ev.update(attrs)
            sink.emit(ev)


def init_run(obs_dir: str, meta: Optional[Dict[str, Any]] = None
             ) -> EventSink:
    """This process's event sink under ``obs_dir``
    (``events-000.jsonl``: the port runs one process), opened with a
    ``run_start`` event. Files append across restarts."""
    sink = EventSink(os.path.join(obs_dir, 'events-000.jsonl'),
                     static={'host': 0})
    ev: Dict[str, Any] = {'event': 'run_start'}
    if meta:
        ev.update(meta)
    sink.emit(ev)
    return sink


#: torch.cuda.memory_stats keys under the JAX package's memory_stats names
_MEMORY_KEYS = {'bytes_in_use': 'allocated_bytes.all.current',
                'peak_bytes_in_use': 'allocated_bytes.all.peak',
                'bytes_reserved': 'reserved_bytes.all.current'}


def read_memory_stats() -> Dict[str, int]:
    """Card 0's allocator watermarks, with ``bytes_limit`` its memory;
    empty without CUDA or before CUDA is initialized (reading them does
    not initialize it)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    stats = torch.cuda.memory_stats(0)
    out = {k: int(stats[v]) for k, v in _MEMORY_KEYS.items() if v in stats}
    out['bytes_limit'] = int(torch.cuda.get_device_properties(0).total_memory)
    return out


def update_memory_gauges(registry: Any,
                         stats: Optional[Dict[str, int]] = None) -> bool:
    """Feed the device memory watermarks into ``device_memory_bytes
    {kind=...}`` gauges of a MetricsRegistry (``GET /metrics`` refreshes
    them at each scrape). ``stats`` overrides the probe. Returns True when
    anything was set."""
    if registry is None:
        return False
    stats = read_memory_stats() if stats is None else {
        k: int(v) for k, v in stats.items()}
    for kind, v in stats.items():
        registry.gauge('device_memory_bytes',
                       help='device memory watermarks (memory_stats)',
                       kind=kind).set(v)
    return bool(stats)
