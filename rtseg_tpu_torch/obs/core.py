"""Spans, the JSONL event sink and the memory events (counterpart of
rtseg_tpu/obs/core.py).

A *span* times a host region: it emits ``{"event": "span", "name", "ts",
"dur_s", "depth"}`` to the process-global :class:`EventSink` (one JSONL
file a process under the run's directory, ``events-<rank>.jsonl``) and
mirrors the name into an active torch.profiler trace through
``torch.profiler.record_function``, where the JAX package uses
``jax.profiler.TraceAnnotation``. Device memory watermarks come from
``torch.cuda.memory_stats`` under the JAX package's key names;
``emit_memory`` writes them as one ``memory`` event.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

import torch

from ..parallel.mesh import process_index


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
    """This process's event sink under ``obs_dir``, named by its rank in
    the process group (``events-000.jsonl`` without one;
    parallel/mesh.py process_index), opened with a ``run_start`` event.
    Files append across restarts; tools/torch_segscope.py reports the
    segment after the last run_start by default."""
    host = process_index()
    sink = EventSink(os.path.join(obs_dir, f'events-{host:03d}.jsonl'),
                     static={'host': host})
    ev: Dict[str, Any] = {'event': 'run_start'}
    if meta:
        ev.update(meta)
    sink.emit(ev)
    return sink


#: torch.cuda.memory_stats keys under the JAX package's memory_stats names
_MEMORY_KEYS = {'bytes_in_use': 'allocated_bytes.all.current',
                'peak_bytes_in_use': 'allocated_bytes.all.peak',
                'bytes_reserved': 'reserved_bytes.all.current'}

#: the keys of a ``memory`` event: the JAX package's watermark names
_EVENT_KEYS = ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit',
               'largest_alloc_size')


def _card() -> Optional[int]:
    """The current card's index, or None without CUDA or before CUDA is
    initialized (reading the watermarks does not initialize it)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.current_device()


def read_memory_stats() -> Dict[str, int]:
    """The current card's allocator watermarks, with ``bytes_limit`` its
    memory; empty without CUDA or before CUDA is initialized."""
    card = _card()
    if card is None:
        return {}
    stats = torch.cuda.memory_stats(card)
    out = {k: int(stats[v]) for k, v in _MEMORY_KEYS.items() if v in stats}
    out['bytes_limit'] = int(
        torch.cuda.get_device_properties(card).total_memory)
    return out


def largest_segment_bytes(card: int) -> int:
    """The largest segment the caching allocator holds on ``card``
    (torch.cuda.memory_snapshot), the port's ``largest_alloc_size``.

    XLA reports the largest single allocation; PyTorch's statistics keep
    no such figure (``segment.all.peak`` counts segments, not bytes). An
    allocation lives inside one segment, and an allocation above the
    allocator's 1 MiB small-block limit gets a segment of its own rounded
    up to 2 MiB, so the largest segment is the largest allocation alive
    (or freed but still cached) within a rounding. 0 without segments."""
    sizes = [seg['total_size'] for seg in torch.cuda.memory_snapshot()
             if seg.get('device', card) == card]
    return int(max(sizes, default=0))


def emit_memory(sink: Optional[EventSink]) -> None:
    """One ``memory`` event of the current card's watermarks, under the
    JAX package's keys (bytes_in_use, peak_bytes_in_use, bytes_limit,
    largest_alloc_size); nothing without a sink, without CUDA or before
    CUDA is initialized, as the JAX package writes nothing on a backend
    without memory_stats."""
    if sink is None:
        return
    card = _card()
    if card is None:
        return
    stats = read_memory_stats()
    stats['largest_alloc_size'] = largest_segment_bytes(card)
    keep = {k: stats[k] for k in _EVENT_KEYS if k in stats}
    sink.emit({'event': 'memory', 'device': f'cuda:{card}', **keep})


def cache_size(step: Any) -> Optional[int]:
    """A step's count of distinct input signatures (the ``_cache_size``
    that train/step.py's builders attach), the port's counterpart of the
    JAX jit-cache size; None for a callable without one."""
    size_fn = getattr(step, '_cache_size', None)
    if size_fn is None:
        return None
    return int(size_fn())


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
