"""A thread-safe in-process registry of live metrics (counterpart of
rtseg_tpu/obs/metrics.py, the same code: pure stdlib, so the Prometheus
text it renders is the JAX package's, byte for byte).

Monotonic counters, gauges and fixed-bucket histograms that the serving
front end exposes as Prometheus text (``render_prometheus``, ``GET
/metrics``); ``/stats`` and the in-process ``stats()`` methods read the
same objects, so the two views cannot disagree.

Hot path: ``Counter.inc`` / ``Gauge.set`` / ``Histogram.observe`` take a
lock, add, and (histograms) bisect into precomputed bounds and write a
preallocated ring slot. Percentiles come at read time from a sliding
window of the last ``window`` observations: one sort of a copy a snapshot.

Exemplars: a histogram built with ``exemplars=k`` keeps the k slowest
in-window observations and the latest one a bucket, each with its trace
id (``snapshot()['exemplars']``, and OpenMetrics-style
``# {trace_id="..."} <value>`` annotations on the rendered bucket lines).

Each metric guards its state with one lock and snapshots copy under it:
a scrape never sees a histogram whose ``count`` differs from the sum of
its bucket counts, and counter totals are exact under any number of
writer threads.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: default millisecond-scale histogram bounds (serving latencies, step
#: times in ms). Last implicit bucket is +Inf.
DEFAULT_MS_BOUNDS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 30000.0)

#: quantiles rendered for every histogram's sliding window
WINDOW_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ''
    return '{' + ','.join(f'{k}="{v}"' for k, v in key) + '}'


class Counter:
    """Monotonic counter. ``inc`` is exact under concurrent writers."""

    __slots__ = ('name', 'labels', '_lock', '_v')

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ('name', 'labels', '_lock', '_v')

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._v += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


def quantiles_of(sorted_vals: List[float],
                 qs: Iterable[float] = WINDOW_QUANTILES
                 ) -> Dict[float, Optional[float]]:
    """Nearest-rank quantiles off one already-sorted window copy — the
    single-sort path every scrape surface shares."""
    out: Dict[float, Optional[float]] = {}
    n = len(sorted_vals)
    for q in qs:
        if not n:
            out[q] = None
        else:
            idx = min(n - 1, max(0, round(q * (n - 1))))
            out[q] = sorted_vals[idx]
    return out


class Histogram:
    """Fixed-bucket histogram + ring window for online percentiles.

    ``observe`` increments exactly one bucket and the total count under
    the metric lock, so ``count == sum(bucket_counts)`` holds for every
    snapshot a concurrent reader can take. The ring window (preallocated,
    no per-observation allocation) keeps the last ``window`` raw values;
    ``snapshot`` sorts a copy once and derives every quantile from it.

    With ``exemplars=k``, ``observe(v, exemplar=trace_id)`` additionally
    maintains the segtail reservoir (module docstring): the k slowest
    in-window observations plus the latest exemplar per bucket, each
    stamped with its observation ordinal so expiry tracks the window
    exactly. The reservoir costs nothing on exemplar-less observes.
    """

    __slots__ = ('name', 'labels', 'bounds', '_lock', '_counts', '_sum',
                 '_count', '_ring', '_rpos', '_rfill', '_ex_k', '_ex_top',
                 '_ex_bucket')

    def __init__(self, name: str, labels: LabelKey = (),
                 bounds: Tuple[float, ...] = DEFAULT_MS_BOUNDS,
                 window: int = 2048, exemplars: int = 0):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._ring = [0.0] * max(int(window), 1)
        self._rpos = 0
        self._rfill = 0
        self._ex_k = max(int(exemplars), 0)
        #: slowest-k in-window: [(value, trace_id, stamp, bucket)],
        #: ascending by value so [0] is the cheapest to displace
        self._ex_top: List[Tuple[float, str, int, int]] = []
        #: stratified: bucket index -> (value, trace_id, stamp, bucket)
        self._ex_bucket: Dict[int, Tuple[float, str, int, int]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        # bisect_left: Prometheus `le` is an inclusive upper bound, so an
        # observation equal to a bound belongs to that bound's bucket
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._ring[self._rpos] = v
            self._rpos = (self._rpos + 1) % len(self._ring)
            if self._rfill < len(self._ring):
                self._rfill += 1
            if exemplar is not None and self._ex_k:
                self._note_exemplar(v, exemplar, i)

    def _note_exemplar(self, v: float, tid: str, bucket: int) -> None:
        # under self._lock; bounded work (the top list holds <= k entries
        # and only re-sorts when this observation actually enters it)
        stamp = self._count            # ordinal of THIS observation
        self._ex_bucket[bucket] = (v, tid, stamp, bucket)
        horizon = stamp - len(self._ring)
        top = self._ex_top
        if top and top[0][2] <= horizon:
            self._ex_top = top = [e for e in top if e[2] > horizon]
        if len(top) < self._ex_k:
            top.append((v, tid, stamp, bucket))
            top.sort(key=lambda e: e[0])
        elif v >= top[0][0]:
            top[0] = (v, tid, stamp, bucket)
            top.sort(key=lambda e: e[0])

    def _exemplars_locked(self) -> List[Dict[str, Any]]:
        """Current reservoir, expired entries dropped: the window holds
        ordinals (count - rfill, count], so stamp > count - rfill is
        exactly 'still in the window' — every surviving exemplar's value
        sits inside the window's min/max by construction."""
        horizon = self._count - self._rfill
        seen: Dict[int, Tuple[float, str, int, int]] = {}
        for e in self._ex_top:
            if e[2] > horizon:
                seen[e[2]] = e
        for e in self._ex_bucket.values():
            if e[2] > horizon:
                seen.setdefault(e[2], e)
        out = []
        for v, tid, _stamp, i in sorted(seen.values(),
                                        key=lambda e: -e[0]):
            le = '+Inf' if i >= len(self.bounds) else f'{self.bounds[i]:g}'
            out.append({'value': round(v, 3), 'trace_id': tid, 'le': le})
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy: count always equals sum(bucket counts), the
        exemplar list is taken under the same lock acquisition as the
        window (an exemplar can never refer outside the window it ships
        with), and ``quantiles`` derive from one sort of the copy."""
        with self._lock:
            window = (self._ring[:self._rfill]
                      if self._rfill < len(self._ring) else list(self._ring))
            out: Dict[str, Any] = {
                'bounds': self.bounds, 'counts': list(self._counts),
                'sum': self._sum, 'count': self._count, 'window': window}
            if self._ex_k:
                out['exemplars'] = self._exemplars_locked()
        # the one sort per snapshot happens OUTSIDE the lock, on the copy
        out['quantiles'] = quantiles_of(sorted(window))
        return out

    def quantiles(self, qs: Iterable[float] = WINDOW_QUANTILES
                  ) -> Dict[float, Optional[float]]:
        """Sliding-window percentiles (nearest-rank, one sorted copy)."""
        with self._lock:
            vals = sorted(self._ring[:self._rfill]
                          if self._rfill < len(self._ring)
                          else self._ring)
        return quantiles_of(vals, qs)

    def exemplars(self) -> List[Dict[str, Any]]:
        """Current (value, trace_id, le) reservoir, slowest first."""
        with self._lock:
            return self._exemplars_locked()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class _Null:
    """Shared no-op metric for a disabled registry: every write is a
    branchless pass, every read is zero/None."""

    name = 'null'
    labels: LabelKey = ()
    bounds: Tuple[float, ...] = ()
    value = 0
    count = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {'bounds': (), 'counts': [], 'sum': 0.0, 'count': 0,
                'window': [], 'quantiles': {}}

    def quantiles(self, qs: Iterable[float] = WINDOW_QUANTILES
                  ) -> Dict[float, Optional[float]]:
        return {q: None for q in qs}

    def exemplars(self) -> List[Dict[str, Any]]:
        return []


_NULL = _Null()


class MetricsRegistry:
    """Named families of counters/gauges/histograms.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same
    (name, labels) always returns the same object, so independent call
    sites accumulate into one metric. Callers on hot paths hold the
    returned handle — the registry lock is only taken at creation and at
    scrape time. Construct with ``enabled=False`` for a registry whose
    metrics are shared no-ops (the metrics-off side of an overhead
    comparison).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}
        self._types: Dict[str, str] = {}      # family name -> kind
        self._help: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str],
             factory) -> Any:
        if not self.enabled:
            return _NULL
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                prev = self._types.get(name)
                if prev is not None and prev != kind:
                    raise ValueError(
                        f'metric {name!r} already registered as {prev}, '
                        f'cannot re-register as {kind}')
                self._types[name] = kind
                m = factory(name, key[1])
                self._metrics[key] = m
            return m

    def _set_help(self, name: str, help: str) -> None:
        # under the registry lock like every other registry map: a scrape
        # iterating help text must never race a first registration
        # (CPython dict setdefault happens to be atomic; the segrace
        # discipline is one lock per metric map, not bytecode trivia)
        if help and self.enabled:
            with self._lock:
                self._help.setdefault(name, help)

    def counter(self, name: str, help: str = '',
                **labels: str) -> Counter:
        self._set_help(name, help)
        return self._get('counter', name, labels, Counter)

    def gauge(self, name: str, help: str = '', **labels: str) -> Gauge:
        self._set_help(name, help)
        return self._get('gauge', name, labels, Gauge)

    def histogram(self, name: str, help: str = '',
                  bounds: Tuple[float, ...] = DEFAULT_MS_BOUNDS,
                  window: int = 2048, exemplars: int = 0,
                  **labels: str) -> Histogram:
        self._set_help(name, help)
        return self._get(
            'histogram', name, labels,
            lambda n, lk: Histogram(n, lk, bounds=bounds, window=window,
                                    exemplars=exemplars))

    # ------------------------------------------------------------- scraping
    def collect(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._types.get(name)

    def help_text(self, name: str) -> str:
        with self._lock:
            return self._help.get(name, '')

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: counters/gauges flat, histograms with bucket
        counts plus window quantiles (the `/stats` shape). One snapshot
        (one sort) per histogram feeds count, every quantile and the
        exemplar list together."""
        out: Dict[str, Any] = {}
        for m in self.collect():
            key = m.name + _label_str(m.labels)
            if isinstance(m, Histogram):
                snap = m.snapshot()
                qs = snap['quantiles']
                out[key] = {
                    'count': snap['count'],
                    'sum': round(snap['sum'], 3),
                    'p50': qs.get(0.5), 'p95': qs.get(0.95),
                    'p99': qs.get(0.99),
                }
                if snap.get('exemplars'):
                    out[key]['exemplars'] = snap['exemplars']
            else:
                out[key] = m.value
        return out


def _exemplar_str(ex: Optional[Dict[str, Any]]) -> str:
    """OpenMetrics exemplar suffix for one bucket sample line."""
    if ex is None:
        return ''
    return f' # {{trace_id="{ex["trace_id"]}"}} {ex["value"]:g}'


def render_prometheus(reg: MetricsRegistry) -> str:
    """Prometheus text exposition (v0.0.4) of every metric in ``reg``.

    Histograms render the standard cumulative ``_bucket``/``_sum``/
    ``_count`` series plus a ``<name>_window`` summary carrying the
    sliding-window p50/p95/p99, so a scraper (or ``a live poller``) gets
    online percentiles without bucket interpolation. A histogram with an
    exemplar reservoir annotates its bucket lines OpenMetrics-style —
    ``... 17 # {trace_id="deadbeef..."} 153.2`` — one exemplar per bucket
    (``parse_prometheus`` strips them; ``parse_exemplars`` reads them).
    """
    by_family: Dict[str, List[Any]] = {}
    for m in reg.collect():
        by_family.setdefault(m.name, []).append(m)
    lines: List[str] = []
    for name in sorted(by_family):
        fam = by_family[name]
        kind = reg.kind(name) or 'untyped'
        help_text = reg.help_text(name)
        if help_text:
            lines.append(f'# HELP {name} {help_text}')
        lines.append(f'# TYPE {name} {kind}')
        if kind == 'histogram':
            window_lines: List[str] = []
            for m in fam:
                snap = m.snapshot()
                by_le = {}
                for ex in snap.get('exemplars', ()):
                    by_le.setdefault(ex['le'], ex)
                cum = 0
                for bound, c in zip(snap['bounds'], snap['counts']):
                    cum += c
                    lk = dict(m.labels)
                    lk['le'] = f'{bound:g}'
                    lines.append(f'{name}_bucket'
                                 f'{_label_str(_label_key(lk))} {cum}'
                                 + _exemplar_str(by_le.get(lk['le'])))
                cum += snap['counts'][-1] if snap['counts'] else 0
                lk = dict(m.labels)
                lk['le'] = '+Inf'
                lines.append(f'{name}_bucket'
                             f'{_label_str(_label_key(lk))} {cum}'
                             + _exemplar_str(by_le.get('+Inf')))
                lines.append(f'{name}_sum{_label_str(m.labels)} '
                             f'{snap["sum"]:g}')
                lines.append(f'{name}_count{_label_str(m.labels)} '
                             f'{snap["count"]}')
                for q, v in snap['quantiles'].items():
                    if v is None:
                        continue
                    lk = dict(m.labels)
                    lk['quantile'] = f'{q:g}'
                    window_lines.append(
                        f'{name}_window'
                        f'{_label_str(_label_key(lk))} {v:g}')
            if window_lines:
                lines.append(f'# TYPE {name}_window summary')
                lines.extend(window_lines)
        else:
            for m in fam:
                v = m.value
                lines.append(f'{name}{_label_str(m.labels)} {v:g}')
    return '\n'.join(lines) + '\n'


# Process-default registry: ambient access for code that has no natural
# owner to receive one (the trainer and each ServePipeline own their own
# registry so per-run/per-pipeline totals stay exact; they may *also* be
# installed here for discovery by in-process consumers).
_REGISTRY = MetricsRegistry()
_REG_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    with _REG_LOCK:
        prev, _REGISTRY = _REGISTRY, reg
    return prev
