"""Open-loop Poisson load generator and SLO report (counterpart of
rtseg_tpu/serve/loadgen.py, the same generator and gate).

A closed-loop harness sends the next request when the previous one
finishes, so the system under test sets its own arrival rate and queueing
delay cannot show. This generator is open-loop: arrival times are drawn
up front from a seeded exponential(1/RPS) process and requests are fired
on that schedule whether or not earlier ones finished, so overload shows
in the tail latency, the drops and the rejections.

Two targets: in-process (a ServePipeline) and HTTP (one or more running
servers; the server's stage split comes back in ``X-Serve-Timing``, the
replica in ``X-Replica-Id``). ``check_report`` is the gate of
``tools/torch_segserve.py bench --check``. The video functions of the
JAX package raise: the streaming plane is not ported.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import not_ported
from ..data import png
from ..obs.tracing import TRACE_KEY, new_trace_id
from .batcher import ServeDrop, ServeReject
from .engine import Bucket, ServeEngine, assemble_batch, select_bucket
from .headers import (REPLICA_HEADER, TIMING_HEADER, TRACE_HEADER,
                      VERSION_HEADER)
from .pipeline import ServePipeline

_STAGES = ('queue_ms', 'assemble_ms', 'device_ms', 'post_ms', 'decode_ms')

#: how many slowest-request exemplars a bench report carries
_SLOWEST_N = 8


def synth_images(shapes: Sequence[Bucket], seed: int = 0,
                 per_shape: int = 2) -> List[np.ndarray]:
    """Deterministic f32 test images (already "preprocessed"), a few per
    (h, w) so mixed-shape traffic interleaves buckets."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, w, 3)).astype(np.float32)
            for h, w in shapes for _ in range(per_shape)]


def encode_png(image_f32: np.ndarray) -> bytes:
    """f32 image -> PNG bytes for HTTP-mode payloads (data/png.py)."""
    u8 = np.clip(image_f32 * 64 + 128, 0, 255).astype(np.uint8)
    return png.encode(u8)


def _percentiles(vals: Sequence[float]) -> Dict[str, Optional[float]]:
    if not vals:
        return {'p50': None, 'p95': None, 'p99': None}
    arr = np.asarray(vals, np.float64)
    p50, p95, p99 = np.percentile(arr, [50, 95, 99])
    return {'p50': float(p50), 'p95': float(p95), 'p99': float(p99)}


def _open_loop_schedule(n: int, rps: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rps, size=n))


def _sleep_until(target: float) -> None:
    while True:
        d = target - time.perf_counter()
        if d <= 0:
            return
        time.sleep(min(d, 0.002))


def _finalize(report: dict, e2e: List[float],
              stages: Dict[str, List[float]], ok: int, dropped: int,
              rejected: int, errors: int, wall_s: float,
              slowest: Optional[List[dict]] = None) -> dict:
    pct = _percentiles(e2e)
    report.update({
        'ok': ok, 'dropped': dropped, 'rejected': rejected,
        'errors': errors,
        'wall_s': round(wall_s, 3),
        'rps_achieved': round(ok / wall_s, 2) if wall_s > 0 else 0.0,
        'e2e_p50_ms': pct['p50'], 'e2e_p95_ms': pct['p95'],
        'e2e_p99_ms': pct['p99'],
        'stage_mean_ms': {k: (round(float(np.mean(v)), 3) if v else None)
                          for k, v in stages.items()},
    })
    if slowest is not None:
        # the N slowest ok requests, trace id + per-stage split: what to
        # look up in the event log and the flight recorder's dumps
        report['slowest'] = sorted(
            slowest, key=lambda r: -(r.get('e2e_ms') or 0.0))[:_SLOWEST_N]
    return report


def bench_pipeline(pipeline: ServePipeline, images: Sequence[np.ndarray],
                   requests: int, rps: float, seed: int = 0,
                   deadline_ms: Optional[float] = None) -> dict:
    """Open-loop drive of an in-process pipeline. Returns the report dict
    (the engine/batcher stats ride along under 'engine'/'batcher')."""
    arrivals = _open_loop_schedule(requests, rps, seed)
    order = np.random.default_rng(seed + 1).integers(
        0, len(images), requests)
    futures, rejected = [], 0
    t0 = time.perf_counter()
    for i in range(requests):
        _sleep_until(t0 + arrivals[i])
        try:
            # load-gen submit is this mode's ingress: mint the trace id
            # here so the in-process path exercises the same end-to-end
            # propagation the HTTP path gets from X-Trace-Id
            futures.append(pipeline.submit(
                images[int(order[i])], deadline_ms=deadline_ms,
                meta={TRACE_KEY: new_trace_id()}))
        except ServeReject:
            rejected += 1
            futures.append(None)
    e2e: List[float] = []
    stages: Dict[str, List[float]] = {k: [] for k in _STAGES}
    slow: List[dict] = []
    ok = dropped = errors = 0
    for fut in futures:
        if fut is None:
            continue
        try:
            res = fut.result(timeout=120)
        except ServeDrop:
            dropped += 1
            continue
        except Exception:   # noqa: BLE001 — counted, reported, gated on
            errors += 1
            continue
        ok += 1
        e2e.append(res.timings['e2e_ms'])
        for k in _STAGES:
            if k in res.timings:
                stages[k].append(res.timings[k])
        slow.append({'trace_id': res.meta.get(TRACE_KEY),
                     **{k: round(float(v), 3)
                        for k, v in res.timings.items()}})
    wall = time.perf_counter() - t0
    report = {'mode': 'in-process', 'requests': requests,
              'rps_target': rps,
              'batcher': pipeline.batcher.stats(),
              'engine': pipeline.engine.stats()}
    return _finalize(report, e2e, stages, ok, dropped, rejected, errors,
                     wall, slowest=slow)


def bench_http(url, payloads: Sequence[bytes], requests: int,
               rps: float, seed: int = 0, timeout_s: float = 60.0,
               workers: int = 32, query: str = '') -> dict:
    """Open-loop drive of one or more running segserve HTTP servers.
    ``url`` is a single URL (a replica, or a fleet router) or a sequence
    of URLs (client-side round-robin over a replica list). Client-side
    e2e latency; the server's own stage decomposition comes back in
    X-Serve-Timing, per-replica attribution in X-Replica-Id, per-version
    attribution in X-Artifact-Version. ``query`` rides on every request
    (e.g. ``raw=1`` so a shadow compare sees int8 masks, not PNGs)."""
    from urllib import error, request as urlreq

    arrivals = _open_loop_schedule(requests, rps, seed)
    order = np.random.default_rng(seed + 1).integers(
        0, len(payloads), requests)
    urls = [url] if isinstance(url, str) else list(url)
    targets = [u.rstrip('/') + '/predict'
               + (f'?{query}' if query else '') for u in urls]

    def one(i: int, t_sched: float) -> dict:
        body = payloads[int(order[i])]
        tid = new_trace_id()
        req = urlreq.Request(targets[i % len(targets)], data=body,
                             method='POST', headers={TRACE_HEADER: tid})
        try:
            with urlreq.urlopen(req, timeout=timeout_s) as resp:
                resp.read()
                timing = json.loads(
                    resp.headers.get(TIMING_HEADER) or '{}')
                # e2e is anchored at the SCHEDULED arrival, not worker
                # pickup: time spent queued in the client's own thread
                # pool is part of what the user would have waited
                # (coordinated omission otherwise sneaks back in through
                # the client)
                return {'status': 'ok',
                        'e2e_ms': (time.perf_counter() - t_sched) * 1e3,
                        'trace_id': tid,
                        'timing': timing,
                        'replica': resp.headers.get(REPLICA_HEADER),
                        'version': resp.headers.get(VERSION_HEADER),
                        'trace_ok': (resp.headers.get(TRACE_HEADER) == tid
                                     and timing.get(TRACE_KEY) == tid)}
        except error.HTTPError as e:
            e.read()
            return {'status': {503: 'rejected', 504: 'dropped'}.get(
                e.code, 'error'),
                'replica': e.headers.get(REPLICA_HEADER),
                'version': e.headers.get(VERSION_HEADER),
                'trace_ok': e.headers.get(TRACE_HEADER) == tid}
        except Exception:   # noqa: BLE001 — connection-level failure
            return {'status': 'error'}

    results = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = []
        for i in range(requests):
            t_sched = t0 + arrivals[i]
            _sleep_until(t_sched)
            futs.append(pool.submit(one, i, t_sched))
        results = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    e2e = [r['e2e_ms'] for r in results if r['status'] == 'ok']
    stages: Dict[str, List[float]] = {k: [] for k in _STAGES}
    for r in results:
        for k in _STAGES:
            if r['status'] == 'ok' and k in r.get('timing', {}):
                stages[k].append(r['timing'][k])
    slow = [{'trace_id': r['trace_id'],
             'e2e_ms': round(r['e2e_ms'], 3),
             'replica': r.get('replica'),
             **{k: r['timing'][k] for k in _STAGES
                if k in r.get('timing', {})}}
            for r in results if r['status'] == 'ok']
    counts = {s: sum(1 for r in results if r['status'] == s)
              for s in ('ok', 'dropped', 'rejected', 'error')}
    per_replica: Dict[str, int] = {}
    per_version: Dict[str, int] = {}
    for r in results:
        if r['status'] == 'ok' and r.get('replica'):
            per_replica[r['replica']] = per_replica.get(r['replica'],
                                                        0) + 1
        if r['status'] == 'ok' and r.get('version'):
            # ok responses attributed to the artifact version
            # that served them (X-Artifact-Version) — what the canary
            # split-weight gate and the per-version reconciliation
            # against the router's fleet_requests_total{version} consume
            per_version[r['version']] = per_version.get(r['version'],
                                                        0) + 1
    report = {'mode': 'http',
              'url': targets[0] if len(targets) == 1 else targets,
              'requests': requests,
              'rps_target': rps,
              # every response must echo the trace id the client minted
              # (in X-Trace-Id; for 200s also inside X-Serve-Timing)
              'trace_mismatch': sum(
                  1 for r in results if r.get('trace_ok') is False),
              'per_replica': per_replica,
              'replica_skew': replica_skew(per_replica),
              'per_version': per_version}
    return _finalize(report, e2e, stages, counts['ok'], counts['dropped'],
                     counts['rejected'], counts['error'], wall,
                     slowest=slow)


def synth_video(*args, **kwargs):
    raise not_ported('synth_video (video sessions, stream/)', 'The planes')


def make_video_payloads(*args, **kwargs):
    raise not_ported('make_video_payloads (video sessions, stream/)',
                     'The planes')


def bench_video(*args, **kwargs):
    raise not_ported('bench_video (video sessions, stream/)', 'The planes')


def check_video_report(*args, **kwargs):
    raise not_ported('check_video_report (video sessions, stream/)',
                     'The planes')


def format_video_report(*args, **kwargs):
    raise not_ported('format_video_report (video sessions, stream/)',
                     'The planes')


def replica_skew(per_replica: Dict[str, int]) -> Optional[float]:
    """Imbalance of per-replica ok counts: (max - min) / total, so 0 is
    perfectly balanced and 1 is one replica taking everything. None when
    no response carried a replica id (bare single server)."""
    if not per_replica:
        return None
    counts = list(per_replica.values())
    total = sum(counts)
    if total <= 0:
        return None
    return round((max(counts) - min(counts)) / total, 4)


def bench_sequential(engine: ServeEngine, images: Sequence[np.ndarray],
                     requests: int) -> dict:
    """Closed-loop sequential batch-1 baseline: one request at a time,
    each read back before the next. ``engine`` must have batch == 1."""
    if engine.batch != 1:
        raise ValueError('sequential baseline wants a batch-1 engine')
    order = np.arange(requests) % len(images)
    t0 = time.perf_counter()
    for i in order:
        img = images[int(i)]
        bucket = select_bucket(engine.buckets, *img.shape[:2])
        engine.run(bucket, assemble_batch([img], bucket, 1))
    wall = time.perf_counter() - t0
    return {'mode': 'sequential-bs1', 'requests': requests,
            'wall_s': round(wall, 3),
            'rps_achieved': round(requests / wall, 2) if wall > 0 else 0.0}


def check_report(report: dict, p95_ms: float,
                 expect_buckets: Optional[int] = None,
                 max_replica_skew: Optional[float] = None,
                 expect_replicas: Optional[int] = None,
                 canary_version: Optional[str] = None,
                 canary_weight: Optional[float] = None,
                 canary_weight_tol: float = 0.1) -> List[str]:
    """CI gate: the list of violated conditions (empty == pass)."""
    problems = []
    if canary_version is not None and canary_weight is not None:
        # split-weight gate: the observed canary share of ok responses
        # (per X-Artifact-Version) must sit within tol of the configured
        # weight
        ok = report.get('ok', 0)
        seen = (report.get('per_version') or {}).get(canary_version, 0)
        observed = seen / ok if ok else 0.0
        if abs(observed - canary_weight) > canary_weight_tol:
            problems.append(
                f'canary {canary_version} served {observed:.3f} of ok '
                f'traffic, configured weight {canary_weight} '
                f'(tol {canary_weight_tol})')
    if expect_replicas is not None:
        seen = len(report.get('per_replica') or {})
        if seen != expect_replicas:
            problems.append(f'{seen} replicas served traffic, expected '
                            f'{expect_replicas}')
    if max_replica_skew is not None:
        skew = report.get('replica_skew')
        if skew is None or skew > max_replica_skew:
            problems.append(f'replica skew {skew} > max '
                            f'{max_replica_skew} (unbalanced routing)')
    if report.get('dropped', 0):
        problems.append(f"{report['dropped']} deadline drops (want 0)")
    if report.get('rejected', 0):
        problems.append(f"{report['rejected']} admission rejections "
                        f"(want 0)")
    if report.get('errors', 0):
        problems.append(f"{report['errors']} request errors (want 0)")
    if report.get('trace_mismatch', 0):
        problems.append(f"{report['trace_mismatch']} responses did not "
                        f"echo the client trace id (want 0)")
    if report.get('ok', 0) != report.get('requests', 0):
        problems.append(f"only {report.get('ok', 0)}/"
                        f"{report.get('requests', 0)} requests completed")
    p95 = report.get('e2e_p95_ms')
    if p95 is None or p95 > p95_ms:
        problems.append(f'e2e p95 {p95} ms > threshold {p95_ms} ms')
    eng = report.get('engine')
    if eng is not None:
        if eng.get('retraces', 0):
            problems.append(f"{eng['retraces']} retraces (want 0)")
        if expect_buckets is not None \
                and eng.get('executables') != expect_buckets:
            problems.append(
                f"{eng.get('executables')} executables != "
                f"{expect_buckets} configured buckets")
    return problems


def format_report(report: dict) -> str:
    lines = [
        f"segserve bench — {report['mode']} | "
        f"{report['requests']} requests @ {report['rps_target']} rps "
        f"target",
        f"  completed      : {report['ok']} ok | {report['dropped']} "
        f"dropped | {report['rejected']} rejected | "
        f"{report['errors']} errors",
        f"  achieved       : {report['rps_achieved']} rps over "
        f"{report['wall_s']} s",
        f"  e2e p50/p95/p99: {report['e2e_p50_ms'] or float('nan'):.1f} / "
        f"{report['e2e_p95_ms'] or float('nan'):.1f} / "
        f"{report['e2e_p99_ms'] or float('nan'):.1f} ms",
    ]
    st = report.get('stage_mean_ms', {})
    parts = [f'{k[:-3]} {v:.1f}' for k, v in st.items() if v is not None]
    if parts:
        lines.append('  stage means ms : ' + ' | '.join(parts))
    per = report.get('per_replica')
    if per:
        dist = ' | '.join(f'{rid} {n}' for rid, n in sorted(per.items()))
        lines.append(f'  per replica    : {dist} '
                     f'(skew {report.get("replica_skew")})')
    pv = report.get('per_version')
    if pv:
        total = sum(pv.values())
        dist = ' | '.join(f'{v} {n} ({n / total:.2f})'
                          for v, n in sorted(pv.items()))
        lines.append(f'  per version    : {dist}')
    slow = report.get('slowest')
    if slow:
        worst = ' '.join(f"{r.get('trace_id')}({r.get('e2e_ms'):.1f}ms)"
                         for r in slow[:3] if r.get('trace_id'))
        if worst:
            lines.append(f'  slowest        : {worst}')
    eng = report.get('engine')
    if eng:
        lines.append(
            f"  engine         : {eng['executables']} executables over "
            f"buckets {','.join(eng['buckets'])} x batch {eng['batch']} | "
            f"retraces {eng['retraces']}")
    bat = report.get('batcher')
    if bat and bat.get('batches'):
        occ = bat['batched_requests'] / (
            bat['batched_requests'] + bat['padded_slots'])
        lines.append(
            f"  batching       : {bat['batches']} batches | "
            f"mean size {bat['batched_requests'] / bat['batches']:.1f} | "
            f"occupancy {100 * occ:.0f}%")
    if 'baseline' in report:
        base = report['baseline']
        ratio = (report['rps_achieved'] / base['rps_achieved']
                 if base.get('rps_achieved') else float('nan'))
        lines.append(
            f"  vs sequential  : {base['rps_achieved']} rps closed-loop "
            f"bs1 -> {ratio:.2f}x")
    return '\n'.join(lines)
