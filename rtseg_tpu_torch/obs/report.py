"""Read segscope JSONL runs and derive the step-time/goodput breakdown
(a copy of rtseg_tpu/obs/report.py: it reads JSONL, whichever package
wrote it, and gives the JAX package's summary on the same events).

Definitions:

  * step p50/p95   — percentiles of non-compile train-step durations
  * imgs/sec       — total images of non-compile train steps / their
                     summed duration (steady-state throughput)
  * data-wait frac — time blocked on the loader / loop wall
                     (data wait + step time) over all train steps
  * goodput        — productive train-step time (non-compile) / the
                     training-run wall (run() entry -> run_end; trainer
                     construction excluded), i.e. the fraction of the run
                     spent making training progress
  * compile s      — summed duration of steps flagged compile (in the
                     port: the first step of each new input signature,
                     obs/collector.py)

Multi-process runs write one file per rank; timing stats come from the
lowest rank present (per-process clocks don't mix), stall counts from
every rank. The device section's category rows are the port's
CATEGORIES (obs/profile.py), the JAX package's six.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _read_jsonl(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue        # torn tail line from a killed run
    return events


def load_events(path: str, last_run: bool = True) -> List[dict]:
    """Events from one JSONL file or a run directory of events-*.jsonl.

    Sinks append across resumes; ``last_run`` slices each host's stream
    from its final ``run_start`` marker so a resumed run reports only
    itself. Returns events merged across hosts, ordered by timestamp.
    """
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, 'events-*.jsonl')))
        if not files:
            raise FileNotFoundError(f'no events-*.jsonl under {path}')
    elif os.path.isfile(path):
        files = [path]
    else:
        raise FileNotFoundError(path)
    events: List[dict] = []
    for fp in files:
        ev = _read_jsonl(fp)
        if last_run:
            starts = [i for i, e in enumerate(ev)
                      if e.get('event') == 'run_start']
            if starts:
                ev = ev[starts[-1]:]
        events.extend(ev)
    return sorted(events, key=lambda e: e.get('ts', 0.0))


#: the fixed attribution categories surfaced as report/diff rows (other
#: buckets fold into the device section but don't get their own
#: regression row); imported so a category added in profile.py can't
#: silently miss its diff row
from .profile import CATEGORIES as _DEVICE_CATEGORIES  # noqa: E402


def load_roofline(path: str) -> Dict[str, Dict[str, float]]:
    """Parse ``tools/roofline.py --json`` output (one JSON object per
    line) into {model: row}; rows with an ``error`` key are dropped."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict) and 'model' in row \
                    and 'error' not in row:
                out[row['model']] = row
    return out


def _summarize_device(profs: List[dict], memory: Optional[dict],
                      roofline: Optional[Dict[str, Dict[str, float]]],
                      model: Optional[str]) -> Optional[Dict[str, Any]]:
    """Aggregate segprof ``profile`` events (sampled + on-demand) into
    the report's device section. Retraced captures are excluded upstream
    — compile time must not read as model device time."""
    if not profs:
        return None
    cat_ms: Dict[str, float] = {}
    mod_ms: Dict[str, float] = {}
    busy_ms = 0.0
    window_ms = 0.0
    iters = 0
    it_busy_ms = 0.0                   # per-iter numerators: only from
    it_cat_ms: Dict[str, float] = {}   # captures that carry `iters`
    for e in profs:
        busy_ms += float(e.get('device_busy_ms', 0.0))
        window_ms += float(e.get('window_ms', 0.0))
        n = int(e.get('iters', 0))
        iters += n
        if n:
            it_busy_ms += float(e.get('device_busy_ms', 0.0))
        for k, v in (e.get('categories') or {}).items():
            cat_ms[k] = cat_ms.get(k, 0.0) + float(v)
            if n:
                it_cat_ms[k] = it_cat_ms.get(k, 0.0) + float(v)
        for k, v in (e.get('modules') or {}).items():
            mod_ms[k] = mod_ms.get(k, 0.0) + float(v)
    busy_frac = min(1.0, busy_ms / window_ms) if window_ms > 0 else 0.0
    unattr = cat_ms.get('unattributed', 0.0)
    device: Dict[str, Any] = {
        'captures': len(profs),
        'busy_frac': busy_frac,
        'device_busy_ms': round(busy_ms, 3),
        'window_ms': round(window_ms, 3),
        'attributed_frac': (1.0 - unattr / busy_ms) if busy_ms > 0
        else 1.0,
        'category_ms': {k: round(v, 3)
                        for k, v in sorted(cat_ms.items(),
                                           key=lambda kv: -kv[1])},
        'category_shares': {k: round(v / busy_ms, 4)
                            for k, v in sorted(cat_ms.items(),
                                               key=lambda kv: -kv[1])
                            if busy_ms > 0},
        'top_modules': {k: round(v, 3)
                        for k, v in sorted(mod_ms.items(),
                                           key=lambda kv: -kv[1])[:8]},
        # captured iterations (sampled captures carry `iters`; on-demand
        # /debug/profile windows don't — they contribute to the totals
        # above but must stay out of every per-iteration number, whose
        # denominator only counts sampled iterations)
        'iters': iters,
        'ms_per_iter': round(it_busy_ms / iters, 3) if iters else None,
        'category_ms_per_iter': (
            {k: round(v / iters, 4)
             for k, v in sorted(it_cat_ms.items(),
                                key=lambda kv: -kv[1])}
            if iters else None),
    }
    if memory and isinstance(memory.get('peak_bytes_in_use'),
                             (int, float)):
        device['peak_hbm_bytes'] = int(memory['peak_bytes_in_use'])
    # measured MFU = device busy fraction x the analytical roofline
    # ceiling for this model (tools/roofline.py --json): the busy
    # fraction is what the chip actually ran, the ceiling is the best
    # MFU those ops could reach — their product is the honest measured
    # utilization of peak FLOPs (BENCHMARKS.md "Roofline analysis")
    row = (roofline or {}).get(model or '')
    if row:
        ceiling = row.get('lane_adj_ceiling_mfu', row.get('ceiling_mfu'))
        if ceiling is not None:
            device['ceiling_mfu'] = float(ceiling)
            device['measured_mfu'] = round(busy_frac * float(ceiling), 4)
        # segquant: the same busy fraction against the int8 roofline row
        # (MFU of the int8 peak — what an int8 bundle of this model
        # could reach; roofline.py documents the conservative byte
        # counts behind it)
        int8_ceiling = row.get('lane_adj_int8_ceiling_mfu',
                               row.get('int8_ceiling_mfu'))
        if int8_ceiling is not None:
            device['int8_ceiling_mfu'] = float(int8_ceiling)
            device['measured_mfu_int8'] = round(
                busy_frac * float(int8_ceiling), 4)
    return device


def summarize(events: List[dict],
              roofline: Optional[Dict[str, Dict[str, float]]] = None
              ) -> Dict[str, Any]:
    hosts = sorted({e.get('host', 0) for e in events})
    h0 = hosts[0] if hosts else 0

    def mine(e):
        return e.get('host', 0) == h0

    start = next((e for e in events
                  if e.get('event') == 'run_start' and mine(e)), None)
    end = next((e for e in reversed(events)
                if e.get('event') == 'run_end' and mine(e)), None)
    tsteps = [e for e in events if e.get('event') == 'step'
              and e.get('kind') == 'train' and mine(e)]
    vsteps = [e for e in events if e.get('event') == 'step'
              and e.get('kind') == 'val' and mine(e)]
    clean = [e for e in tsteps if not e.get('compile')]
    durs = np.asarray([e['dur_s'] for e in clean], np.float64)
    compile_s = float(sum(e['dur_s'] for e in tsteps + vsteps
                          if e.get('compile')))
    stalls = [e for e in events if e.get('event') == 'stall']
    # segwarm: one `compile` event per executable build (trainer steps,
    # serve buckets, bench compiles), flagged cache_hit when the segwarm
    # cache served it — the cold-vs-warm startup story. Host-0 only, like
    # the other timing stats.
    builds = [e for e in events if e.get('event') == 'compile' and mine(e)]
    startup_cold_s = float(sum(e.get('dur_s', 0.0) for e in builds
                               if not e.get('cache_hit')))
    startup_warm_s = float(sum(e.get('dur_s', 0.0) for e in builds
                               if e.get('cache_hit')))

    if end is not None and 'wall_s' in end:
        wall = float(end['wall_s'])
    else:
        # crashed/killed run: no run_end marker. Approximate the same
        # window run_end would have covered (the train/val loop, not
        # trainer construction): first step event to the last event seen.
        ts = [e['ts'] for e in events if 'ts' in e]
        t0 = min((e['ts'] for e in tsteps + vsteps if 'ts' in e),
                 default=min(ts) if ts else 0.0)
        wall = (max(ts) - t0) if len(ts) > 1 else 0.0

    productive = float(durs.sum()) if durs.size else 0.0
    imgs = int(sum(e.get('imgs', 0) for e in clean))
    waits = [float(e.get('data_wait_s', 0.0)) for e in tsteps]
    busy = float(sum(e['dur_s'] for e in tsteps)) + sum(waits)

    # serving section: request/batch events from the segserve pipeline
    # (rtseg_tpu/serve). Counts come from every host; latency percentiles
    # from all hosts too — request timings are durations, not clock
    # readings, so cross-host mixing is sound.
    reqs = [e for e in events if e.get('event') == 'request']
    batches = [e for e in events if e.get('event') == 'batch']
    serving: Optional[Dict[str, Any]] = None
    if reqs:
        okr = [e for e in reqs if e.get('status', 'ok') == 'ok']
        e2e = np.asarray([float(e['e2e_ms']) for e in okr
                          if 'e2e_ms' in e], np.float64)
        ts_r = [e['ts'] for e in reqs if 'ts' in e]
        window = (max(ts_r) - min(ts_r)) if len(ts_r) > 1 else 0.0

        def _pct(q):
            return float(np.percentile(e2e, q)) if e2e.size else None

        stage_means = {}
        for key in ('queue_ms', 'assemble_ms', 'device_ms', 'post_ms',
                    'decode_ms'):
            vals = [float(e[key]) for e in okr if key in e]
            if vals:
                stage_means[key] = round(float(np.mean(vals)), 3)
        sizes = np.asarray([int(e.get('size', 0)) for e in batches],
                           np.float64)
        caps = np.asarray([max(int(e.get('cap', 1)), 1) for e in batches],
                          np.float64)
        serving = {
            'requests': len(reqs),
            'ok': len(okr),
            'dropped': len([e for e in reqs
                            if e.get('status') == 'dropped']),
            'rejected': len([e for e in reqs
                             if e.get('status') == 'rejected']),
            'rps': len(okr) / window if window > 0 else 0.0,
            'e2e_p50_ms': _pct(50), 'e2e_p95_ms': _pct(95),
            'e2e_p99_ms': _pct(99),
            'stage_mean_ms': stage_means,
            'batches': len(batches),
            'mean_batch': float(sizes.mean()) if sizes.size else 0.0,
            'occupancy': (float((sizes / caps).mean()) if sizes.size
                          else 0.0),
        }

    # segstream: per-frame events from the streaming session plane
    # (stream/frontend.py emits 'frame' and 'session'; the fleet router
    # emits 'session_migrate'). Counts from every host — one stream
    # spans router + replica processes, like the rollout story. Jitter
    # is the mean of per-session stddevs of ok-frame e2e (cross-session
    # mixing would let two steady sessions at different latencies read
    # as jitter); freshness is the mean mask age in frames (0 = every
    # response came from a full network pass).
    frames = [e for e in events if e.get('event') == 'frame']
    sess_ev = [e for e in events if e.get('event') == 'session']
    migrations = [e for e in events
                  if e.get('event') == 'session_migrate']
    streaming: Optional[Dict[str, Any]] = None
    if frames or sess_ev or migrations:
        okf = [e for e in frames if e.get('status') == 'ok']
        e2e_by_sess: Dict[str, List[float]] = {}
        for e in okf:
            if 'e2e_ms' in e:
                e2e_by_sess.setdefault(
                    str(e.get('session', '?')), []).append(
                        float(e['e2e_ms']))
        e2e_all = np.asarray([v for vs in e2e_by_sess.values()
                              for v in vs], np.float64)
        jitters = [float(np.std(np.asarray(vs, np.float64)))
                   for vs in e2e_by_sess.values() if len(vs) > 1]
        ages = [float(e['mask_age']) for e in okf if 'mask_age' in e]
        provs = [e.get('provenance', '?') for e in okf]
        keyframes = provs.count('keyframe')
        actions = [e.get('action', '?') for e in sess_ev]

        def _fpct(q):
            return float(np.percentile(e2e_all, q)) if e2e_all.size \
                else None

        streaming = {
            'frames': len(frames),
            'ok': len(okf),
            'dropped_late': len([e for e in frames
                                 if e.get('status') == 'dropped_late']),
            'stale': len([e for e in frames
                          if e.get('status') == 'stale']),
            'errors': len([e for e in frames
                           if e.get('status') == 'error']),
            'sessions': len(e2e_by_sess),
            'session_actions': {a: actions.count(a)
                                for a in sorted(set(actions))},
            'migrations': len(migrations),
            'provenance': {p: provs.count(p)
                           for p in sorted(set(provs))},
            'keyframe_ratio': (keyframes / len(okf) if okf else None),
            'frame_p50_ms': _fpct(50), 'frame_p99_ms': _fpct(99),
            'jitter_ms': (float(np.mean(jitters)) if jitters
                          else None),
            'freshness': (float(np.mean(ages)) if ages else None),
        }

    # segship: rollout transitions (registry/rollout.py emit_rollout) —
    # the deploy story next to the run it happened during. Counts come
    # from every host (one rollout spans router + controller processes).
    rollouts = [e for e in events if e.get('event') == 'rollout']
    rollout: Optional[Dict[str, Any]] = None
    if rollouts:
        acts = [e.get('action', '?') for e in rollouts]
        last = rollouts[-1]
        rollout = {
            'events': len(rollouts),
            'actions': {a: acts.count(a) for a in sorted(set(acts))},
            'last_action': last.get('action'),
            'last_version': last.get('version'),
            'last_reason': last.get('reason'),
        }

    # segtail: flight-recorder dumps (obs/flight.py) — how many times a
    # trigger fired, what fired it, and the captured traffic mix of the
    # most recent dump (the replay artifact ROADMAP item 4 consumes).
    fdumps = [e for e in events if e.get('event') == 'flight_dump']
    flight: Optional[Dict[str, Any]] = None
    if fdumps:
        reasons = [e.get('reason', '?') for e in fdumps]
        last = fdumps[-1]
        flight = {
            'dumps': len(fdumps),
            'reasons': {r: reasons.count(r) for r in sorted(set(reasons))},
            'records': sum(int(e.get('records', 0)) for e in fdumps),
            'last_source': last.get('source'),
            'last_path': last.get('path'),
            'traffic_mix': last.get('traffic_mix'),
        }

    spans: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get('event') != 'span' or not mine(e):
            continue
        agg = spans.setdefault(e.get('name', '?'),
                               {'count': 0, 'total_s': 0.0})
        agg['count'] += 1
        agg['total_s'] = round(agg['total_s'] + float(e.get('dur_s', 0.0)),
                               6)

    # segpipe: host->device transfer stage (data/h2d spans from the
    # trainer's put path — under async prefetch this time overlaps device
    # compute, so a large h2d total with near-zero data-wait is healthy)
    h2d = spans.get('data/h2d')
    h2d_s = float(h2d['total_s']) if h2d else None
    h2d_n = int(h2d['count']) if h2d else 0
    # segpipe: packed-cache hit rate (per-epoch 'cache' events from the
    # loaders; hits = mmap reads, misses = decode-path fetches). Only
    # cache-backed loaders count — uncached runs also emit decode-fetch
    # events (cached: false) but a run with no cache has no hit rate.
    cev = [e for e in events if e.get('event') == 'cache'
           and e.get('cached') and mine(e)]
    hits = sum(int(e.get('hits', 0)) for e in cev)
    misses = sum(int(e.get('misses', 0)) for e in cev)
    cache_hit_rate = hits / (hits + misses) if (hits + misses) else None
    memory = next((e for e in reversed(events)
                   if e.get('event') == 'memory' and mine(e)), None)
    # segprof: sampled/on-demand device-time attribution. Retraced
    # captures (jit cache grew mid-window) are excluded — their windows
    # contain XLA compile time masquerading as op time.
    profs = [e for e in events if e.get('event') == 'profile'
             and mine(e) and not e.get('retraced')]
    device = _summarize_device(profs, memory, roofline,
                               (start or {}).get('model'))

    # flat per-category rows for diff_table (ms per captured iteration —
    # comparable across runs with different capture counts)
    dev_flat: Dict[str, Optional[float]] = {
        f'dev_{cat}_ms': None for cat in _DEVICE_CATEGORIES}
    dev_flat['device_busy_frac'] = None
    dev_flat['peak_hbm_bytes'] = None
    if device is not None:
        dev_flat['device_busy_frac'] = device['busy_frac']
        dev_flat['peak_hbm_bytes'] = device.get('peak_hbm_bytes')
        per_iter = device.get('category_ms_per_iter')
        if per_iter is not None:
            for cat in _DEVICE_CATEGORIES:
                dev_flat[f'dev_{cat}_ms'] = per_iter.get(cat, 0.0)

    return {
        'run': {k: v for k, v in (start or {}).items()
                if k not in ('event', 'ts', 'host')},
        'hosts': len(hosts),
        'train_steps': len(tsteps),
        'compile_steps': len([e for e in tsteps + vsteps
                              if e.get('compile')]),
        'val_steps': len(vsteps),
        'step_p50_s': float(np.percentile(durs, 50)) if durs.size else None,
        'step_p95_s': float(np.percentile(durs, 95)) if durs.size else None,
        'imgs_per_sec': imgs / productive if productive > 0 else 0.0,
        'data_wait_frac': sum(waits) / busy if busy > 0 else 0.0,
        'goodput': productive / wall if wall > 0 else 0.0,
        'compile_s': compile_s,
        'startup_compiles': len(builds),
        'startup_cache_hits': len([e for e in builds
                                   if e.get('cache_hit')]),
        'startup_compile_s': startup_cold_s + startup_warm_s,
        'startup_cold_s': startup_cold_s,
        'startup_warm_s': startup_warm_s,
        'stalls': len(stalls),
        'wall_s': wall,
        'h2d_s': h2d_s,
        'h2d_transfers': h2d_n,
        'cache_hits': hits,
        'cache_misses': misses,
        'cache_hit_rate': cache_hit_rate,
        'epochs': len([e for e in events if e.get('event') == 'epoch'
                       and e.get('kind') == 'train' and mine(e)]),
        'serving': serving,
        'streaming': streaming,
        'rollout': rollout,
        'flight': flight,
        # flattened for diff_table's flat-key rows
        'serve_p99_ms': serving['e2e_p99_ms'] if serving else None,
        'serve_rps': serving['rps'] if serving else None,
        'frame_p99_ms': streaming['frame_p99_ms'] if streaming else None,
        'frame_jitter_ms': streaming['jitter_ms'] if streaming else None,
        'frame_freshness': streaming['freshness'] if streaming else None,
        'frame_dropped_late': (streaming['dropped_late'] if streaming
                               else None),
        'keyframe_ratio': (streaming['keyframe_ratio'] if streaming
                           else None),
        'device': device,
        'profile_captures': len(profs),
        **dev_flat,
        'spans': spans,
        'memory': ({k: v for k, v in memory.items()
                    if k not in ('event', 'ts', 'host')}
                   if memory else None),
    }


def _ms(v: Optional[float]) -> str:
    return f'{1e3 * v:.2f} ms' if v is not None else '—'


def format_summary(s: Dict[str, Any], path: str = '') -> str:
    run = s.get('run', {})
    meta = ' '.join(f'{k}={run[k]}' for k in
                    ('model', 'dataset', 'devices') if k in run)
    lines = [
        f'segscope report — {path}' if path else 'segscope report',
        f'  run            : {meta or "(no metadata)"}'
        f' | hosts={s["hosts"]} epochs={s["epochs"]}',
        f'  train steps    : {s["train_steps"]} | val steps: '
        f'{s["val_steps"]} | compile steps (train+val): '
        f'{s["compile_steps"]}',
        f'  step p50 / p95 : {_ms(s["step_p50_s"])} / '
        f'{_ms(s["step_p95_s"])}',
        f'  imgs/sec       : {s["imgs_per_sec"]:.1f}',
        f'  data-wait      : {100 * s["data_wait_frac"]:.1f}%',
        f'  goodput        : {100 * s["goodput"]:.1f}%',
        f'  compile        : {s["compile_s"]:.2f} s',
        f'  stalls         : {s["stalls"]}',
        f'  wall           : {s["wall_s"]:.1f} s',
    ]
    if s.get('startup_compiles'):
        lines.append(
            f'  startup compile: {s["startup_compile_s"]:.2f} s over '
            f'{s["startup_compiles"]} executables '
            f'({s["startup_compiles"] - s["startup_cache_hits"]} fresh '
            f'{s["startup_cold_s"]:.2f} s, {s["startup_cache_hits"]} '
            f'cache-hit {s["startup_warm_s"]:.2f} s)')
    if s.get('h2d_s') is not None:
        per = (1e3 * s['h2d_s'] / s['h2d_transfers']
               if s['h2d_transfers'] else 0.0)
        lines.append(
            f'  h2d            : {s["h2d_s"]:.2f} s over '
            f'{s["h2d_transfers"]} transfers ({per:.2f} ms each'
            f'{", overlapped" if s["data_wait_frac"] < 0.01 else ""})')
    if s.get('cache_hit_rate') is not None:
        lines.append(
            f'  cache-hit rate : {100 * s["cache_hit_rate"]:.1f}% '
            f'({s["cache_hits"]}/{s["cache_hits"] + s["cache_misses"]} '
            f'sample fetches from the packed cache)')
    if s.get('serving'):
        sv = s['serving']

        def _m(v):
            return f'{v:.1f}' if v is not None else '—'

        lines += [
            f'  serving        : {sv["ok"]}/{sv["requests"]} ok | '
            f'drops {sv["dropped"]} | rejects {sv["rejected"]} | '
            f'{sv["rps"]:.1f} rps',
            f'  request p50/p95/p99 : {_m(sv["e2e_p50_ms"])} / '
            f'{_m(sv["e2e_p95_ms"])} / {_m(sv["e2e_p99_ms"])} ms',
        ]
        st = sv.get('stage_mean_ms', {})
        if st:
            lines.append('  stage means    : ' + ' | '.join(
                f'{k[:-3]} {v:.1f}ms' for k, v in st.items()))
        if sv['batches']:
            lines.append(
                f'  batching       : {sv["batches"]} batches | mean size '
                f'{sv["mean_batch"]:.1f} | occupancy '
                f'{100 * sv["occupancy"]:.0f}%')
    if s.get('streaming'):
        st = s['streaming']

        def _m(v, spec='.1f'):
            return format(v, spec) if v is not None else '—'

        acts = st.get('session_actions', {})
        act_str = ' '.join(f'{a}={n}' for a, n in acts.items()) or '—'
        lines += [
            f'  streaming      : {st["ok"]}/{st["frames"]} frames ok | '
            f'dropped-late {st["dropped_late"]} | stale {st["stale"]} | '
            f'errors {st["errors"]} | {st["sessions"]} sessions',
            f'  frame p50/p99  : {_m(st["frame_p50_ms"])} / '
            f'{_m(st["frame_p99_ms"])} ms | jitter '
            f'{_m(st["jitter_ms"])} ms | freshness '
            f'{_m(st["freshness"], ".2f")} frames',
            f'  scheduling     : keyframe ratio '
            f'{_m(st["keyframe_ratio"], ".3f")} | sessions {act_str} | '
            f'migrations {st["migrations"]}',
        ]
        prov = st.get('provenance', {})
        if prov:
            lines.append('  provenance     : ' + ' | '.join(
                f'{p} {n}' for p, n in prov.items()))
    if s.get('rollout'):
        ro = s['rollout']
        acts = ' | '.join(f'{a} x{n}' for a, n in ro['actions'].items())
        lines.append(
            f'  rollout        : {acts} — last {ro["last_action"]} '
            f'{ro["last_version"]}'
            + (f' ({ro["last_reason"]})' if ro.get('last_reason')
               else ''))
    if s.get('flight'):
        fl = s['flight']
        reasons = ' | '.join(f'{r} x{n}'
                             for r, n in fl['reasons'].items())
        lines.append(
            f'  flight dumps   : {fl["dumps"]} ({reasons}) — '
            f'{fl["records"]} records, last from {fl["last_source"]}')
    if s.get('device'):
        dv = s['device']
        per_iter = (f' | {dv["ms_per_iter"]:.1f} device-ms/iter'
                    if dv.get('ms_per_iter') is not None else '')
        lines.append(
            f'  device         : busy {100 * dv["busy_frac"]:.1f}% over '
            f'{dv["captures"]} capture(s) | attributed '
            f'{100 * dv["attributed_frac"]:.1f}%{per_iter}')
        shares = dv.get('category_shares') or {}
        if shares:
            lines.append('  device categories: ' + ' | '.join(
                f'{k} {100 * v:.1f}%'
                for k, v in list(shares.items())[:7]))
        mods = dv.get('top_modules') or {}
        if mods:
            lines.append('  top modules    : ' + '; '.join(
                f'{k} {v:.1f}ms' for k, v in list(mods.items())[:5]))
        if dv.get('measured_mfu') is not None:
            lines.append(
                f'  measured MFU   : {100 * dv["measured_mfu"]:.1f}% '
                f'(busy {100 * dv["busy_frac"]:.1f}% x roofline ceiling '
                f'{100 * dv["ceiling_mfu"]:.1f}%)')
        if dv.get('measured_mfu_int8') is not None:
            lines.append(
                f'  int8 MFU       : '
                f'{100 * dv["measured_mfu_int8"]:.1f}% of int8 peak '
                f'(ceiling {100 * dv["int8_ceiling_mfu"]:.1f}%, '
                f'segquant)')
        if dv.get('peak_hbm_bytes') is not None:
            lines.append(f'  peak HBM       : '
                         f'{dv["peak_hbm_bytes"] / 2**20:.0f} MiB')
    if s.get('memory'):
        mem = s['memory']
        parts = [f'{k}={v / 2**20:.0f}MiB' for k, v in mem.items()
                 if isinstance(v, (int, float))]
        lines.append(f'  device memory  : {" ".join(parts)}')
    if s.get('spans'):
        top = sorted(s['spans'].items(), key=lambda kv: -kv[1]['total_s'])
        lines.append('  top spans      : ' + '; '.join(
            f'{name} {agg["total_s"]:.2f}s x{agg["count"]}'
            for name, agg in top[:5]))
    return '\n'.join(lines)


#: (key, label, unit scale, higher_is_better)
_DIFF_ROWS = (
    ('step_p50_s', 'step p50 (ms)', 1e3, False),
    ('step_p95_s', 'step p95 (ms)', 1e3, False),
    ('imgs_per_sec', 'imgs/sec', 1.0, True),
    ('data_wait_frac', 'data-wait (%)', 100.0, False),
    ('h2d_s', 'h2d (s)', 1.0, False),
    ('cache_hit_rate', 'cache-hit (%)', 100.0, True),
    ('goodput', 'goodput (%)', 100.0, True),
    ('compile_s', 'compile (s)', 1.0, False),
    # segwarm: executable-build seconds at startup (a warm-start
    # regression — cache misses creeping back in — shows here)
    ('startup_compile_s', 'startup compile (s)', 1.0, False),
    ('stalls', 'stalls', 1.0, False),
    # serving rows (None — rendered as '—' — for training-only runs)
    ('serve_p99_ms', 'serve p99 (ms)', 1.0, False),
    ('serve_rps', 'serve RPS', 1.0, True),
    # segstream rows (None — rendered as '—' — for non-streaming runs).
    # keyframe_ratio counts as lower-is-better: the scheduler's whole
    # point is answering frames without the full network, so a ratio
    # creeping up is the streaming analogue of a throughput regression
    # (quality is gated separately, by the bench's mIoU-delta table).
    ('frame_p99_ms', 'frame p99 (ms)', 1.0, False),
    ('frame_jitter_ms', 'frame jitter (ms)', 1.0, False),
    ('frame_freshness', 'frame freshness (frames)', 1.0, False),
    ('frame_dropped_late', 'frames dropped late', 1.0, False),
    ('keyframe_ratio', 'keyframe ratio (%)', 100.0, False),
    # segprof device-attribution rows: busy fraction (higher = the chip
    # is actually working) and per-category device ms per captured
    # iteration (a collective/copy share creeping up shows here — the
    # quantization/autoscaling consumers in ROADMAP items 1-2)
    ('device_busy_frac', 'device busy (%)', 100.0, True),
    # one row per profile.CATEGORIES entry — derived, so a category
    # added there gets its regression row (and --check gate) for free
    *((f'dev_{cat}_ms', f'dev {cat} (ms/iter)', 1.0, False)
      for cat in _DEVICE_CATEGORIES),
    ('peak_hbm_bytes', 'peak HBM (MiB)', 1.0 / 2**20, False),
)

#: relative change beyond which a worse metric is labeled a regression
_REGRESSION_THRESHOLD = 0.05

#: absolute floor (in row units, post-scale) under which a device-ms row
#: can't regress: +5% of 0.02 ms is profiler noise, not a regression
_DEVICE_MS_FLOOR = 0.5


def diff_rows(a: Dict[str, Any], b: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-metric comparison rows for A (baseline) vs B: ``{key, label,
    a, b, delta, regressed}``; values are None when either run lacks the
    metric. The machine-readable half of :func:`diff_table` — ``segscope
    diff --check`` gates on any ``regressed`` row."""
    rows: List[Dict[str, Any]] = []
    for key, label, scale, higher_better in _DIFF_ROWS:
        va, vb = a.get(key), b.get(key)
        if va is None or vb is None:
            rows.append({'key': key, 'label': label, 'a': None, 'b': None,
                         'delta': None, 'regressed': False})
            continue
        va, vb = scale * va, scale * vb
        if va:
            rel = (vb - va) / abs(va)
        else:
            rel = 0.0 if vb == 0 else float('inf')
        worse = rel > _REGRESSION_THRESHOLD if not higher_better \
            else rel < -_REGRESSION_THRESHOLD
        if worse and key.startswith('dev_') \
                and max(abs(va), abs(vb)) < _DEVICE_MS_FLOOR:
            worse = False          # sub-floor category: profiler noise
        rows.append({'key': key, 'label': label,
                     'a': round(va, 4), 'b': round(vb, 4),
                     # json.dumps renders float('inf') as the non-RFC
                     # token `Infinity`, so a 0 -> nonzero jump carries
                     # the same string diff_table prints
                     'delta': rel if math.isfinite(rel) else '+inf',
                     'regressed': worse})
    return rows


def diff_table(a: Dict[str, Any], b: Dict[str, Any],
               rows: Optional[List[Dict[str, Any]]] = None) -> str:
    """Markdown regression table comparing run A (baseline) to run B.
    Pass precomputed ``rows`` (from :func:`diff_rows`) so the table and
    a ``--check`` verdict derive from the same comparison."""
    lines = ['| metric | A | B | delta |', '|---|---|---|---|']
    for row in (diff_rows(a, b) if rows is None else rows):
        if row['a'] is None or row['b'] is None:
            lines.append(f'| {row["label"]} | — | — | — |')
            continue
        rel = row['delta']
        if isinstance(rel, str):           # '+inf' from diff_rows
            delta = rel
        else:
            delta = f'{100 * rel:+.1f}%'
        mark = ' REGRESSED' if row['regressed'] else ''
        lines.append(f'| {row["label"]} | {row["a"]:.2f} | '
                     f'{row["b"]:.2f} | {delta}{mark} |')
    return '\n'.join(lines)
