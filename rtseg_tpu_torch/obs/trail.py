"""Trace assembly: one trace id -> one causally-ordered, gap-attributed
timeline across every plane that touched the request (a copy of
rtseg_tpu/obs/trail.py).

Each plane writes its own evidence: a router emits one ``hop`` event per
routed request, the replica's batcher and pipeline emit
``ingress``/``batch``/``request`` (serve/batcher.py, serve/pipeline.py),
a streaming front end emits ``frame`` events, and flight-recorder dumps
(flight.py) persist ``flight-*.jsonl`` snapshots of the same shapes. This
module joins them: given sink directories (a root dir covers its
``replica-*/`` subdirs), it finds every record carrying the trace id and
assembles a single timeline whose stages sum *exactly* to the end-to-end
time — any time the planes cannot attribute lands in one explicit
``unattributed residue`` row, never in a silent gap.

Attribution when the router hop is present::

    hop.e2e_ms                          the anchor: router recv -> reply
      router admit+route                hop.e2e_ms - hop.upstream_ms
      network + http (gap)              hop.upstream_ms - request.e2e_ms
      replica decode/queue/assemble/device/post   from the request event
      unattributed residue              anchor - everything above

Without a hop (single replica, in-process bench) the replica ``request``
event anchors; a streaming ``frame`` event outranks it (the frame's
sequencing wait wraps the pipeline's work).

Consumed by ``tools/torch_segscope.py trace <id>``. Pure stdlib;
host-side only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .tracing import TRACE_KEY

#: replica request stages in causal order, with display labels
_REQUEST_STAGES: Tuple[Tuple[str, str], ...] = (
    ('decode_ms', 'replica decode'),
    ('queue_ms', 'replica queue'),
    ('assemble_ms', 'assemble'),
    ('device_ms', 'device'),
    ('post_ms', 'post'),
)


# ------------------------------------------------------------------ loading
def find_sink_files(dirs: Sequence[str]) -> List[str]:
    """Every event log and flight snapshot under the given sink dirs,
    recursively — one fleet obs root covers router + replica subdirs."""
    out: List[str] = []
    for d in dirs:
        for pat in ('events-*.jsonl', 'flight-*.jsonl'):
            out.extend(glob.glob(os.path.join(d, '**', pat),
                                 recursive=True))
    return sorted(set(out))

def _rel_source(path: str, dirs: Sequence[str]) -> str:
    for d in dirs:
        try:
            rel = os.path.relpath(path, d)
        except ValueError:          # different drive (windows)
            continue
        if not rel.startswith('..'):
            return rel
    return path


def load_trace(dirs: Sequence[str], trace_id: str
               ) -> List[Dict[str, Any]]:
    """Every event/flight record across the sink dirs that carries the
    trace id (directly, or in a batch event's ``traces`` list). Flight
    records become pseudo-events typed by their recorder's plane —
    ``hop`` for the router ring, ``request`` for a replica ring — so a
    trace survives even when one plane's event log is gone. Sorted by
    ts; each record is tagged with its ``_source`` file."""
    found: List[Dict[str, Any]] = []
    for path in find_sink_files(dirs):
        name = os.path.basename(path)
        flight = name.startswith('flight-')
        flight_kind = None
        if flight:
            flight_kind = 'hop' if '-router-' in name else 'request'
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue                  # torn tail
                    tid = rec.get(TRACE_KEY)
                    if tid != trace_id and \
                            trace_id not in (rec.get('traces') or ()):
                        continue
                    if flight:
                        rec.setdefault('event', flight_kind)
                    rec['_flight'] = flight
                    rec['_source'] = _rel_source(path, dirs)
                    found.append(rec)
        except OSError:
            continue
    found.sort(key=lambda e: e.get('ts') or 0.0)
    return found


# ----------------------------------------------------------------- assembly
def _first(cands: List[Dict[str, Any]],
           live_ids: frozenset) -> Optional[Dict[str, Any]]:
    """Prefer a real sink event over a flight-ring pseudo-event of the
    same type (the ring may hold a stale duplicate)."""
    for e in cands:
        if id(e) in live_ids:
            return e
    return cands[0] if cands else None


def assemble(events: List[Dict[str, Any]], trace_id: str
             ) -> Optional[Dict[str, Any]]:
    """One timeline for the trace: anchor, causally-ordered stage rows,
    and an explicit residue so the rows always sum to the anchor e2e."""
    # identity set of non-flight records: the live-vs-flight preference
    # keys off it so the synthetic ``_flight`` tag is never read in a
    # typed (per-event-schema) context
    live_ids = frozenset(id(e) for e in events if not e.get('_flight'))
    hops = [e for e in events if e.get('event') == 'hop']
    reqs = [e for e in events if e.get('event') == 'request']
    ingresses = [e for e in events if e.get('event') == 'ingress']
    batches = [e for e in events if e.get('event') == 'batch']
    frames = [e for e in events if e.get('event') == 'frame']
    hop = _first(hops, live_ids)
    req = _first(reqs, live_ids)
    frame = _first(frames, live_ids)
    ingress = _first(ingresses, live_ids)
    batch = _first(batches, live_ids)
    if hop is None and req is None and frame is None:
        return None

    rows: List[Dict[str, Any]] = []

    def row(hop_name: str, stage: str, ms: Optional[float],
            source: Optional[Dict[str, Any]]) -> None:
        if ms is None:
            return
        rows.append({'hop': hop_name, 'stage': stage,
                     'ms': round(float(ms), 3),
                     'source': (source or {}).get('_source')})

    anchor_kind = 'replica'
    total = None
    status = None
    if req is not None:
        total = req.get('e2e_ms')
        status = req.get('status')
    if frame is not None and frame.get('e2e_ms') is not None:
        if total is not None:
            row('stream', 'frame sequencing (gap)',
                max(0.0, frame['e2e_ms'] - total), frame)
        anchor_kind = 'stream'
        status = frame.get('status') or status
        total = frame.get('e2e_ms')
    if hop is not None and hop.get('e2e_ms') is not None:
        upstream = hop.get('upstream_ms')
        inner = total
        if upstream is not None:
            row('router', 'router admit+route',
                max(0.0, hop['e2e_ms'] - upstream), hop)
            if inner is not None:
                row('router', 'network + http (gap)',
                    max(0.0, upstream - inner), hop)
        anchor_kind = 'router'
        status = hop.get('status') or status
        total = hop.get('e2e_ms')
    if req is not None:
        for key, label in _REQUEST_STAGES:
            row('replica', label, req.get(key), req)
    if total is None:
        return None

    attributed = sum(r['ms'] for r in rows)
    residue = round(float(total) - attributed, 3)
    rows.append({'hop': anchor_kind, 'stage': 'unattributed residue',
                 'ms': residue, 'source': None})

    anchor = hop if anchor_kind == 'router' else (
        frame if anchor_kind == 'stream' else req)
    timeline: Dict[str, Any] = {
        'trace_id': trace_id,
        'anchor': anchor_kind,
        'status': status,
        'e2e_ms': round(float(total), 3),
        'rows': rows,
        'residue_ms': residue,
        'sources': sorted({e['_source'] for e in events
                           if e.get('_source')}),
        'events': [{'ts': e.get('ts'), 'event': e.get('event'),
                    'source': e.get('_source'),
                    'flight': bool(e.get('_flight'))} for e in events],
    }
    if hop is not None:
        timeline['route'] = {k: hop.get(k) for k in
                             ('group', 'version', 'replica', 'attempts')}
    if ingress is not None:
        timeline['bucket'] = ingress.get('bucket')
    elif req is not None:
        timeline['bucket'] = req.get('bucket')
    if batch is not None:
        timeline['batch'] = {'size': batch.get('size'),
                             'wait_ms': batch.get('wait_ms')}
    if frame is not None:
        timeline['frame'] = {'session': frame.get('session'),
                             'seq': frame.get('seq'),
                             'provenance': frame.get('provenance')}
    return timeline


def assemble_trace(dirs: Sequence[str], trace_id: str
                   ) -> Optional[Dict[str, Any]]:
    """load_trace + assemble in one call (the segscope entry point)."""
    events = load_trace(dirs, trace_id)
    if not events:
        return None
    return assemble(events, trace_id)


# --------------------------------------------------------------- formatting
def format_timeline(tl: Dict[str, Any]) -> str:
    lines = [f"segscope trace {tl['trace_id']} — "
             f"{len(tl['events'])} records across "
             f"{len(tl['sources'])} files"]
    anchor = f"{tl['anchor']} (status {tl.get('status')})"
    if tl.get('route'):
        r = tl['route']
        anchor += (f" group {r.get('group')} version {r.get('version')}"
                   f" replica {r.get('replica')}")
    lines.append(f'  anchor : {anchor}')
    if tl.get('bucket'):
        lines.append(f"  bucket : {tl['bucket']}")
    if tl.get('batch'):
        lines.append(f"  batch  : size {tl['batch']['size']} "
                     f"(waited {tl['batch']['wait_ms']} ms)")
    if tl.get('frame'):
        fr = tl['frame']
        lines.append(f"  frame  : session {fr.get('session')} "
                     f"seq {fr.get('seq')} "
                     f"provenance {fr.get('provenance')}")
    lines.append(f"  e2e    : {tl['e2e_ms']:.3f} ms")
    lines.append('')
    lines.append(f"  {'hop':<8} {'stage':<26} {'ms':>10} {'share':>7}")
    total = tl['e2e_ms'] or 1.0
    for row in tl['rows']:
        share = 100.0 * row['ms'] / total if total else 0.0
        lines.append(f"  {row['hop']:<8} {row['stage']:<26} "
                     f"{row['ms']:>10.3f} {share:>6.1f}%")
    lines.append(f"  {'':<8} {'total':<26} {total:>10.3f} {100.0:>6.1f}%")
    lines.append('')
    lines.append('  causal record:')
    for e in tl['events']:
        tag = ' [flight]' if e['flight'] else ''
        lines.append(f"    {e['ts'] or 0:.6f}  {e['event']:<12} "
                     f"{e['source']}{tag}")
    return '\n'.join(lines)
