"""segscope live: follow a *running* system instead of reporting on a
finished one (a copy of rtseg_tpu/obs/live.py).

Two sources, one refreshing SLO summary:

  * **/metrics polling** — target is an ``http(s)://`` URL: each frame
    scrapes the serve front end's Prometheus text exposition
    (obs/metrics.py ``render_prometheus``) and renders request totals by
    status, windowed p50/p95/p99, queue depth, occupancy and — when the
    target is a trainer-side exporter — step/goodput gauges. Rates
    (RPS, imgs/s) come from counter deltas between consecutive polls.
  * **sink tailing** — target is an obs dir (or one events-*.jsonl
    file): frames read only the *new* bytes since the previous frame
    (per-file offsets, torn-tail tolerant) and summarize a sliding
    window of recent events, so following a multi-hour run costs the
    tail, not a full re-parse.

``check_frame`` is the gate behind ``torch_segscope.py live --check``: it
fails on any stall, any request error, a p99 over the ``--p99-ms``
threshold, or a target that shows no activity at all (almost always a
wrong path/URL — better a loud failure than a vacuously green gate).

Pure stdlib.
"""

from __future__ import annotations

import glob
import json
import os
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

Labels = Tuple[Tuple[str, str], ...]


# --------------------------------------------------------------- prometheus
def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Prometheus text -> {family: [(labels, value), ...]}."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        if ' # ' in line:
            # OpenMetrics exemplar annotation — value parses without it
            line = line.split(' # ', 1)[0].rstrip()
        try:
            name_part, value_part = line.rsplit(' ', 1)
            value = float(value_part)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        if '{' in name_part:
            name, rest = name_part.split('{', 1)
            rest = rest.rstrip('}')
            for pair in rest.split(','):
                if '=' in pair:
                    k, v = pair.split('=', 1)
                    labels[k.strip()] = v.strip().strip('"')
        else:
            name = name_part
        out.setdefault(name, []).append((labels, value))
    return out


def parse_exemplars(text: str) -> Dict[str, List[Dict[str, Any]]]:
    """OpenMetrics exemplar annotations -> {family: [{le, trace_id,
    value}, ...]} (slowest first). The renderer (metrics.py
    ``render_prometheus``) attaches ``# {trace_id="..."} <value>`` to
    ``_bucket`` lines; this is the scrape-side inverse, so a live p99
    always links to concrete trace ids."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith('#') or ' # ' not in line:
            continue
        series, annot = line.split(' # ', 1)
        name_part = series.split(' ', 1)[0]
        if '_bucket{' not in name_part:
            continue
        family = name_part.split('_bucket{', 1)[0]
        le = None
        for pair in name_part.split('{', 1)[1].rstrip('}').split(','):
            if pair.startswith('le='):
                le = pair.split('=', 1)[1].strip('"')
        try:
            body, val = annot.rsplit(' ', 1)
            tid = body.split('trace_id="', 1)[1].split('"', 1)[0]
            ex = {'le': le, 'trace_id': tid, 'value': float(val)}
        except (IndexError, ValueError):
            continue
        out.setdefault(family, []).append(ex)
    for exs in out.values():
        exs.sort(key=lambda e: -e['value'])
    return out


def trigger_flight(url: str, reason: str = 'manual',
                   timeout_s: float = 10.0) -> Dict[str, Any]:
    """POST /debug/flight on a replica or router — the operator/CI leg
    of the flight-recorder trigger table (obs/flight.py)."""
    req = urllib.request.Request(
        url.rstrip('/') + '/debug/flight',
        data=json.dumps({'reason': reason}).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def _family_value(parsed: Dict, name: str,
                  **want: str) -> Optional[float]:
    for labels, value in parsed.get(name, ()):
        if all(labels.get(k) == v for k, v in want.items()):
            return value
    return None


def _family_sum(parsed: Dict, name: str) -> float:
    return sum(v for _, v in parsed.get(name, ()))


def scrape_counter_sum(urls, family: str, timeout_s: float = 10.0,
                       **labels: str) -> int:
    """Scrape ``<url>/metrics`` for each url and sum one counter family
    across them, keeping only series whose labels match ``labels`` —
    the replica-side leg of the router-vs-replica reconciliation gates
    (tools/segfleet.py, tools/segship.py share this one implementation
    so the two CLIs' gates cannot drift)."""
    total = 0
    for url in ([urls] if isinstance(urls, str) else urls):
        if url is None:
            continue
        with urllib.request.urlopen(url.rstrip('/') + '/metrics',
                                    timeout=timeout_s) as resp:
            parsed = parse_prometheus(resp.read().decode())
        total += int(sum(
            v for lab, v in parsed.get(family, ())
            if all(lab.get(k) == want for k, want in labels.items())))
    return total


class MetricsPoller:
    """Scrape ``<url>/metrics`` and derive the live frame; counter deltas
    between consecutive polls become rates."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        self.url = url.rstrip('/')
        if not self.url.endswith('/metrics'):
            self.url += '/metrics'
        self.timeout_s = timeout_s
        self._last: Optional[Tuple[float, Dict[str, float]]] = None

    def poll(self) -> Dict[str, Any]:
        with urllib.request.urlopen(self.url,
                                    timeout=self.timeout_s) as resp:
            text = resp.read().decode()
        parsed = parse_prometheus(text)
        exemplars = parse_exemplars(text)
        now = time.monotonic()
        statuses = {labels.get('status', '?'): int(v)
                    for labels, v in parsed.get('serve_requests_total',
                                                ())}
        hist_count = _family_sum(parsed, 'serve_request_e2e_ms_count')
        totals = {'ok': statuses.get('ok', 0),
                  'imgs': int(_family_value(parsed, 'train_imgs_total',
                                            kind='train') or 0)}
        rates: Dict[str, Optional[float]] = {'rps': None,
                                             'imgs_per_sec': None}
        if self._last is not None:
            t_prev, prev = self._last
            dt = now - t_prev
            if dt > 0:
                rates['rps'] = (totals['ok'] - prev['ok']) / dt
                rates['imgs_per_sec'] = (totals['imgs']
                                         - prev['imgs']) / dt
        self._last = (now, totals)

        def _q(name: str, q: str) -> Optional[float]:
            return _family_value(parsed, name + '_window', quantile=q)

        frame: Dict[str, Any] = {
            'source': self.url, 'mode': 'metrics',
            'serving': None, 'train': None, 'stalls': None,
            'device': None,
        }
        # segprof gauges: busy fraction of the last profile capture and
        # the device memory watermarks (refreshed by the server at scrape
        # time; absent on backends without memory_stats)
        busy = _family_value(parsed, 'device_busy_frac')
        peak = _family_value(parsed, 'device_memory_bytes',
                             kind='peak_bytes_in_use')
        captures = _family_value(parsed, 'profile_captures_total')
        if busy is not None or peak is not None:
            frame['device'] = {
                'busy_frac': busy,
                'peak_hbm_bytes': peak,
                'captures': int(captures) if captures is not None else 0,
            }
        if 'serve_requests_total' in parsed \
                or 'serve_request_e2e_ms_count' in parsed:
            frame['serving'] = {
                'ok': statuses.get('ok', 0),
                'rejected': statuses.get('rejected', 0),
                'dropped': statuses.get('dropped', 0),
                'errors': statuses.get('error', 0),
                'hist_count': int(hist_count),
                'rps': rates['rps'],
                'p50_ms': _q('serve_request_e2e_ms', '0.5'),
                'p95_ms': _q('serve_request_e2e_ms', '0.95'),
                'p99_ms': _q('serve_request_e2e_ms', '0.99'),
                'queue_depth': _family_value(parsed, 'serve_queue_depth'),
                'occupancy': _occupancy(
                    _family_sum(parsed, 'serve_batched_requests_total'),
                    _family_sum(parsed, 'serve_padded_slots_total')),
                'exemplars': (exemplars.get('serve_request_e2e_ms')
                              or exemplars.get('fleet_e2e_ms')
                              or [])[:4],
            }
        if _family_value(parsed, 'train_steps_total',
                         kind='train') is not None:
            frame['train'] = {
                'steps': int(_family_value(parsed, 'train_steps_total',
                                           kind='train') or 0),
                'compile_steps': int(_family_value(
                    parsed, 'train_compile_steps_total',
                    kind='train') or 0),
                'step_p50_ms': _q('train_step_ms', '0.5'),
                'step_p95_ms': _q('train_step_ms', '0.95'),
                'imgs_per_sec': rates['imgs_per_sec'],
                'data_wait_frac': _family_value(
                    parsed, 'train_data_wait_frac', kind='train'),
                'goodput': _family_value(parsed, 'train_goodput',
                                         kind='train'),
            }
        return frame


def _occupancy(batched: float, padded: float) -> Optional[float]:
    total = batched + padded
    return batched / total if total > 0 else None


# --------------------------------------------------------------- sink tail
def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class SinkTailer:
    """Incrementally follow an obs dir's events-*.jsonl streams.

    Each ``poll`` reads bytes appended since the previous poll (new files
    are picked up as they appear), keeps a sliding window of recent
    request/step events (``window_s``, by event ``ts``) for percentiles
    and rates, and running totals since the tail started for counts.
    A torn tail line (writer mid-append) stays buffered until its
    newline arrives.
    """

    def __init__(self, path: str, window_s: float = 30.0):
        if os.path.isdir(path):
            self.dir, self.files = path, None
        elif os.path.isfile(path):
            self.dir, self.files = None, [path]
        else:
            raise FileNotFoundError(path)
        self.window_s = window_s
        self._offsets: Dict[str, int] = {}
        self._buffers: Dict[str, str] = {}
        self._recent: List[dict] = []     # request/step events, windowed
        self.totals = {'ok': 0, 'rejected': 0, 'dropped': 0,
                       'ingress': 0, 'stalls': 0, 'steps': 0,
                       'compile_steps': 0, 'captures': 0}
        # segstream: frame-status / provenance / session-action running
        # totals (frame percentiles come from the sliding window)
        self.frame_totals = {'ok': 0, 'dropped_late': 0, 'stale': 0,
                             'error': 0}
        self.frame_keyframes = 0
        self.session_actions: Dict[str, int] = {}
        self.migrations = 0
        self.run_meta: Dict[str, Any] = {}
        # segprof: last non-retraced profile capture + peak HBM seen
        self._busy_frac: Optional[float] = None
        self._peak_hbm: Optional[float] = None
        # segship: rollout transition tally + the latest one seen
        self._rollout_actions: Dict[str, int] = {}
        self._rollout_last: Optional[Dict[str, Any]] = None
        # segtail: flight-recorder dumps seen so far + the latest one
        self.flight_dumps = 0
        self._flight_last: Optional[Dict[str, Any]] = None

    def _paths(self) -> List[str]:
        if self.files is not None:
            return self.files
        return sorted(glob.glob(os.path.join(self.dir,
                                             'events-*.jsonl')))

    def _read_new(self) -> List[dict]:
        events: List[dict] = []
        for path in self._paths():
            try:
                with open(path) as f:
                    f.seek(self._offsets.get(path, 0))
                    chunk = f.read()
                    self._offsets[path] = f.tell()
            except OSError:
                continue
            data = self._buffers.get(path, '') + chunk
            # hold an unterminated tail line for the next poll
            lines = data.split('\n')
            self._buffers[path] = lines.pop()
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return events

    def poll(self) -> Dict[str, Any]:
        now_ts = time.time()
        for e in self._read_new():
            kind = e.get('event')
            if kind == 'run_start':
                self.run_meta = {k: v for k, v in e.items()
                                 if k not in ('event', 'ts', 'host')}
            elif kind == 'ingress':
                self.totals['ingress'] += 1
            elif kind == 'stall':
                self.totals['stalls'] += 1
            elif kind == 'request':
                status = e.get('status', 'ok')
                if status in self.totals:
                    self.totals[status] += 1
                self._recent.append(e)
            elif kind == 'step':
                self.totals['steps'] += 1
                if e.get('compile'):
                    self.totals['compile_steps'] += 1
                self._recent.append(e)
            elif kind == 'frame':
                status = e.get('status', 'ok')
                if status in self.frame_totals:
                    self.frame_totals[status] += 1
                if status == 'ok' \
                        and e.get('provenance') == 'keyframe':
                    self.frame_keyframes += 1
                self._recent.append(e)
            elif kind == 'session':
                a = e.get('action', '?')
                self.session_actions[a] = \
                    self.session_actions.get(a, 0) + 1
            elif kind == 'session_migrate':
                self.migrations += 1
            elif kind == 'profile':
                self.totals['captures'] += 1
                if not e.get('retraced') \
                        and e.get('busy_frac') is not None:
                    self._busy_frac = float(e['busy_frac'])
            elif kind == 'memory':
                peak = e.get('peak_bytes_in_use')
                if isinstance(peak, (int, float)):
                    self._peak_hbm = max(self._peak_hbm or 0.0,
                                         float(peak))
            elif kind == 'rollout':
                a = e.get('action', '?')
                self._rollout_actions[a] = \
                    self._rollout_actions.get(a, 0) + 1
                self._rollout_last = {
                    'action': a, 'version': e.get('version'),
                    'reason': e.get('reason')}
            elif kind == 'flight_dump':
                self.flight_dumps += 1
                self._flight_last = {
                    'reason': e.get('reason'),
                    'source': e.get('source'),
                    'records': e.get('records'),
                    'path': e.get('path')}
        cutoff = now_ts - self.window_s
        self._recent = [e for e in self._recent
                        if e.get('ts', now_ts) >= cutoff]

        reqs = [e for e in self._recent if e.get('event') == 'request'
                and e.get('status', 'ok') == 'ok' and 'e2e_ms' in e]
        e2e = sorted(float(e['e2e_ms']) for e in reqs)
        steps = [e for e in self._recent if e.get('event') == 'step'
                 and e.get('kind') == 'train']
        durs = sorted(1e3 * float(e['dur_s']) for e in steps
                      if not e.get('compile'))
        # rate denominator: the observed activity span, capped at the
        # window — so one `--once` frame over a short finished burst
        # reports the burst's real rate, not burst/window
        recent_ts = [e['ts'] for e in self._recent if 'ts' in e]
        span_s = min(self.window_s,
                     max(now_ts - min(recent_ts), 1e-3)) \
            if recent_ts else self.window_s
        frame: Dict[str, Any] = {
            'source': self.dir or self.files[0], 'mode': 'sink',
            'run': self.run_meta, 'stalls': self.totals['stalls'],
            'serving': None, 'train': None, 'device': None,
            'streaming': None,
            'rollout': ({'actions': dict(self._rollout_actions),
                         'last': self._rollout_last}
                        if self._rollout_actions else None),
            'flight': ({'dumps': self.flight_dumps,
                        'last': self._flight_last}
                       if self.flight_dumps else None),
        }
        if self._busy_frac is not None or self._peak_hbm is not None:
            frame['device'] = {
                'busy_frac': self._busy_frac,
                'peak_hbm_bytes': self._peak_hbm,
                'captures': self.totals['captures'],
            }
        if self.totals['ingress'] or self.totals['ok'] \
                or self.totals['rejected'] or self.totals['dropped']:
            frame['serving'] = {
                'ok': self.totals['ok'],
                'rejected': self.totals['rejected'],
                'dropped': self.totals['dropped'],
                'errors': 0,     # pipeline errors don't emit events;
                                 # poll /metrics for the error counter
                'rps': len(reqs) / span_s if span_s > 0 else None,
                'p50_ms': _pct(e2e, 0.5), 'p95_ms': _pct(e2e, 0.95),
                'p99_ms': _pct(e2e, 0.99),
                'queue_depth': None, 'occupancy': None,
                # windowed slowest-first exemplars, same shape as the
                # /metrics-poll mode gets from parse_exemplars
                'exemplars': [
                    {'trace_id': e.get('trace_id'),
                     'value': round(float(e['e2e_ms']), 3), 'le': None}
                    for e in sorted(reqs,
                                    key=lambda e: -float(e['e2e_ms']))[:4]
                    if e.get('trace_id')],
            }
        if any(self.frame_totals.values()) or self.session_actions \
                or self.migrations:
            fr = [e for e in self._recent if e.get('event') == 'frame'
                  and e.get('status') == 'ok' and 'e2e_ms' in e]
            fr_e2e = sorted(float(e['e2e_ms']) for e in fr)
            ok = self.frame_totals['ok']
            frame['streaming'] = {
                **self.frame_totals,
                'sessions': dict(self.session_actions),
                'migrations': self.migrations,
                'keyframe_ratio': (self.frame_keyframes / ok
                                   if ok else None),
                'fps': len(fr) / span_s if span_s > 0 else None,
                'frame_p50_ms': _pct(fr_e2e, 0.5),
                'frame_p99_ms': _pct(fr_e2e, 0.99),
            }
        if self.totals['steps']:
            wait = sum(float(e.get('data_wait_s', 0.0)) for e in steps)
            busy = sum(float(e.get('dur_s', 0.0)) for e in steps) + wait
            imgs = sum(int(e.get('imgs', 0)) for e in steps
                       if not e.get('compile'))
            frame['train'] = {
                'steps': self.totals['steps'],
                'compile_steps': self.totals['compile_steps'],
                'step_p50_ms': _pct(durs, 0.5),
                'step_p95_ms': _pct(durs, 0.95),
                'imgs_per_sec': (imgs / span_s if span_s > 0 else None),
                'data_wait_frac': wait / busy if busy > 0 else None,
                'goodput': None,     # needs the run wall; report-time
            }
        return frame


# ------------------------------------------------------------------ output
def _fmt(v: Optional[float], pattern: str = '{:.1f}') -> str:
    return pattern.format(v) if v is not None else '—'


def format_frame(frame: Dict[str, Any]) -> str:
    lines = [f'segscope live — {frame["source"]}'
             f' ({time.strftime("%H:%M:%S")})']
    sv = frame.get('serving')
    if sv:
        lines += [
            f'  requests       : {sv["ok"]} ok | {sv["dropped"]} dropped '
            f'| {sv["rejected"]} rejected | {sv["errors"]} errors',
            f'  rps            : {_fmt(sv["rps"])}',
            f'  e2e p50/p95/p99: {_fmt(sv["p50_ms"])} / '
            f'{_fmt(sv["p95_ms"])} / {_fmt(sv["p99_ms"])} ms',
        ]
        if sv.get('queue_depth') is not None:
            lines.append(f'  queue depth    : {sv["queue_depth"]:.0f}')
        if sv.get('occupancy') is not None:
            lines.append(
                f'  occupancy      : {100 * sv["occupancy"]:.0f}%')
        if sv.get('exemplars'):
            tail = ' '.join(f'{ex["trace_id"]}({ex["value"]:g}ms)'
                            for ex in sv['exemplars'])
            lines.append(f'  p99 exemplars  : {tail}')
    tr = frame.get('train')
    if tr:
        lines += [
            f'  train steps    : {tr["steps"]} '
            f'({tr["compile_steps"]} compile)',
            f'  step p50 / p95 : {_fmt(tr["step_p50_ms"])} / '
            f'{_fmt(tr["step_p95_ms"])} ms',
            f'  imgs/sec       : {_fmt(tr["imgs_per_sec"])}',
        ]
        if tr.get('data_wait_frac') is not None:
            lines.append(f'  data-wait      : '
                         f'{100 * tr["data_wait_frac"]:.1f}%')
        if tr.get('goodput') is not None:
            lines.append(f'  goodput        : '
                         f'{100 * tr["goodput"]:.1f}%')
    st = frame.get('streaming')
    if st:
        kr = (f'{st["keyframe_ratio"]:.3f}'
              if st.get('keyframe_ratio') is not None else '—')
        sess = ' '.join(f'{a}={n}'
                        for a, n in sorted(st['sessions'].items())) \
            or '—'
        lines += [
            f'  frames         : {st["ok"]} ok | {st["dropped_late"]} '
            f'dropped-late | {st["stale"]} stale | {st["error"]} errors'
            f' | {_fmt(st["fps"])} fps',
            f'  frame p50/p99  : {_fmt(st["frame_p50_ms"])} / '
            f'{_fmt(st["frame_p99_ms"])} ms | keyframe ratio {kr}',
            f'  sessions       : {sess} | migrations '
            f'{st["migrations"]}',
        ]
    ro = frame.get('rollout')
    if ro:
        acts = ' | '.join(f'{a} x{n}'
                          for a, n in sorted(ro['actions'].items()))
        last = ro.get('last') or {}
        lines.append(f'  rollout        : {acts} — last '
                     f'{last.get("action")} {last.get("version")}')
    fl = frame.get('flight')
    if fl:
        last = fl.get('last') or {}
        lines.append(f'  flight dumps   : {fl["dumps"]} — last '
                     f'{last.get("reason")} ({last.get("source")}, '
                     f'{last.get("records")} records)')
    dv = frame.get('device')
    if dv:
        busy = (f'{100 * dv["busy_frac"]:.1f}%'
                if dv.get('busy_frac') is not None else '—')
        peak = (f'{dv["peak_hbm_bytes"] / 2**20:.0f} MiB'
                if dv.get('peak_hbm_bytes') is not None else '—')
        lines.append(f'  device         : busy {busy} | peak HBM {peak}'
                     f' | {dv.get("captures", 0)} capture(s)')
    if frame.get('stalls') is not None:
        lines.append(f'  stalls         : {frame["stalls"]}')
    if not sv and not tr and not st:
        lines.append('  (no activity observed yet)')
    return '\n'.join(lines)


def check_frame(frame: Dict[str, Any],
                p99_ms: Optional[float] = None,
                max_hbm_bytes: Optional[float] = None) -> List[str]:
    """CI gate: list of violated conditions (empty == pass)."""
    problems: List[str] = []
    sv = frame.get('serving')
    tr = frame.get('train')
    st = frame.get('streaming')
    if sv is None and tr is None and st is None:
        problems.append('no serving, streaming or training activity '
                        'observed (wrong target?)')
    if sv:
        if sv.get('errors'):
            problems.append(f"{sv['errors']} request errors (want 0)")
        if p99_ms is not None:
            p99 = sv.get('p99_ms')
            if p99 is None or p99 > p99_ms:
                problems.append(
                    f'request p99 {_fmt(p99)} ms > threshold {p99_ms} ms')
    if st and st.get('error'):
        problems.append(f"{st['error']} frame errors (want 0)")
    if max_hbm_bytes is not None:
        dv = frame.get('device') or {}
        peak = dv.get('peak_hbm_bytes')
        if peak is not None and peak > max_hbm_bytes:
            problems.append(
                f'peak HBM {peak / 2**20:.0f} MiB > threshold '
                f'{max_hbm_bytes / 2**20:.0f} MiB')
    if frame.get('stalls'):
        problems.append(f"{frame['stalls']} stalls (want 0)")
    return problems
