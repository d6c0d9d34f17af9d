#!/usr/bin/env python3
"""Probe: does a torch.profiler capture of another thread's work lose the
window's start as the process ages, and which capture route keeps it?

    python3 tools/torch_profile_age.py [--ages 5,30,90,180,300]
        [--window-ms 500] [--lead-s 1.5] [--flush]
        [--out chiprun_out/profile_age.json]

Runs on the card. Two processes, side by side, each with a traffic
thread that keeps launching work on its own stream (two kernels an
iteration and a replayed three-kernel CUDA graph every fourth, about 2k
launches a second), as a server's batcher does, and one profiler session
right at its start (the age counts from it). At each age (seconds since
that session), the main thread captures `--window-ms` of the traffic:

  * process ``sessions``: route ``fresh``, a session opened at the
    window's start (obs/profile.py capture_window today); then route
    ``lead``, a session opened `--lead-s` before the window, the window
    cut from it by time;
  * process ``kept``: route ``kept``, one session kept open since the
    previous capture (since the start for the first), the window cut
    from it by time, and the session opened again right after;
  * process ``flush`` (with `--flush`): route ``flush``, a session
    opened at the window's start whose CUPTI activity buffers are
    flushed by force (`cuptiActivityFlushAll(1)` through ctypes) before
    it stops.

Besides, each row has the traffic's iterations a second over its window
(`rate`, against `rate_off`, the same over the second before the
capture: with no session on, but in process ``kept`` with its kept
session on) and the process's resident memory (`rss_mb`).

A window is marked by a `record_function` range on the main thread;
its launches are the traffic thread's kernel, graph, copy and memset
launches whose runtime call starts inside it, up to 20 ms before its
end. For each capture: the launches, those whose device work the trace
lacks (`lost`), how far into the window the first launch with its work
lies (`first_kept_ms`), and the least (kernel start - launch start)
over the window's matched pairs (`skew_ms`: below 0 the GPU's
timestamps run behind the CPU's, the premise of a re-based clock).
Prints one JSON line a capture and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TAIL_US = 20e3          # launches this close to the window's end may run
#                         after the capture stopped: not counted


class Traffic:
    """A thread that launches work on its own stream until `stop`."""

    def __init__(self):
        import torch
        self.stop_flag = threading.Event()
        self.dev = torch.device('cuda')
        self.stream = torch.cuda.Stream()
        self.x = torch.randn(256, 256, device=self.dev)
        self.w = torch.randn(256, 256, device=self.dev)
        with torch.cuda.stream(self.stream):
            self.x @ self.w                       # cuBLAS init, off-graph
        self.stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.g_out = (self.x @ self.w).relu_().sum()
        self.tid = None
        self.iters = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import torch
        self.tid = threading.get_native_id()
        with torch.cuda.stream(self.stream):
            while not self.stop_flag.is_set():
                (self.x @ self.w).relu_()
                if self.iters % 4 == 0:
                    self.graph.replay()
                self.iters += 1
                if self.iters % 20 == 0:
                    self.stream.synchronize()
                time.sleep(0.001)
        self.stream.synchronize()

    def stop(self):
        self.stop_flag.set()
        self.thread.join(timeout=10)


def _cupti():
    """libcupti as this process loaded it (torch's), or None."""
    import ctypes
    for name in ('libcupti.so', 'libcupti.so.12', 'libcupti.so.13'):
        try:
            return ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_GLOBAL)
        except OSError:
            continue
    import glob
    import torch
    for path in sorted(glob.glob(os.path.join(
            os.path.dirname(os.path.dirname(torch.__file__)), 'nvidia',
            'cuda_cupti', 'lib', 'libcupti.so*'))):
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


def _rss_mb() -> float:
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith('VmRSS:'):
                return int(line.split()[1]) / 1024
    return 0.0


def _session():
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _events(prof) -> list:
    from rtseg_tpu_torch.obs.profile import load_trace_events
    d = tempfile.mkdtemp(prefix='profile_age_')
    try:
        prof.export_chrome_trace(os.path.join(d, 'age.pt.trace.json'))
        xevents, _ = load_trace_events(d)
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
    return xevents


def _window(prof, window_s: float):
    """Mark `window_s` of traffic on this thread."""
    import torch
    with torch.profiler.record_function('profile_age_window'):
        time.sleep(window_s)


def window_stats(xevents: list, main_tid: int) -> dict:
    """The other threads' launches inside the marked window (the main
    thread sleeps through it) against the device work the trace holds
    (module docstring)."""
    from rtseg_tpu_torch.obs.profile import (DEVICE_CATS, LAUNCH_CATS,
                                             _WORK_CALLS)
    marks = [e for e in xevents if e.get('name') == 'profile_age_window']
    if not marks:
        return {'error': 'no window mark in the trace'}
    t0 = float(marks[0]['ts'])
    t1 = t0 + float(marks[0].get('dur', 0.0))
    device = {}
    for e in xevents:
        if e.get('cat') in DEVICE_CATS:
            corr = (e.get('args') or {}).get('correlation')
            device.setdefault(corr, float(e['ts']))
    launches, lost, first_kept, skews = 0, 0, None, []
    for e in xevents:
        args = e.get('args') or {}
        if e.get('cat') not in LAUNCH_CATS or e.get('tid') == main_tid \
                or 'correlation' not in args \
                or not any(c in e.get('name', '') for c in _WORK_CALLS):
            continue
        ts = float(e['ts'])
        if not t0 <= ts < t1 - TAIL_US:
            continue
        launches += 1
        start = device.get(args['correlation'])
        if start is None:
            lost += 1
            continue
        skews.append(start - ts)
        if first_kept is None or ts < first_kept:
            first_kept = ts
    return {'launches': launches, 'lost': lost,
            'first_kept_ms': (None if first_kept is None
                              else round((first_kept - t0) / 1e3, 3)),
            'skew_ms': round(min(skews) / 1e3, 3) if skews else None,
            'window_ms': round((t1 - t0) / 1e3, 3)}


def run(route: str, ages, window_s: float, lead_s: float) -> list:
    import torch
    main_tid = threading.get_native_id()
    traffic = Traffic()
    while traffic.tid is None:
        time.sleep(0.01)
    first = _session()
    time.sleep(0.05)
    first.stop()
    born = time.perf_counter()
    kept = _session() if route == 'kept' else None
    rows = []
    cupti = _cupti() if route == 'flush' else None
    if route == 'flush':
        print(json.dumps({'cupti': None if cupti is None
                          else cupti._name}), flush=True)
    for age in ages:
        time.sleep(max(0.0, born + age - 1.0 - time.perf_counter()))
        n0, t0 = traffic.iters, time.perf_counter()
        time.sleep(1.0)
        rate_off = (traffic.iters - n0) / (time.perf_counter() - t0)
        caps = {'kept': ('kept',), 'flush': ('flush',)}.get(
            route, ('fresh', 'lead'))
        for cap in caps:
            t_age = time.perf_counter() - born
            if cap in ('fresh', 'flush'):
                prof = _session()
            elif cap == 'lead':
                prof = _session()
                time.sleep(lead_s)
            else:
                prof = kept
            n0, t0 = traffic.iters, time.perf_counter()
            _window(prof, window_s)
            rate = (traffic.iters - n0) / (time.perf_counter() - t0)
            torch.cuda.synchronize()
            if cap == 'flush' and cupti is not None:
                cupti.cuptiActivityFlushAll(1)
            prof.stop()
            if cap == 'kept':
                kept = None
            row = {'route': cap, 'age_s': round(t_age, 1),
                   'rate': round(rate, 1), 'rate_off': round(rate_off, 1),
                   'rss_mb': round(_rss_mb(), 1),
                   **window_stats(_events(prof), main_tid)}
            del prof
            if cap == 'kept':
                kept = _session()
            print(json.dumps(row), flush=True)
            rows.append(row)
    if kept is not None:
        kept.stop()
    traffic.stop()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ages', default='5,30,90,180,300')
    ap.add_argument('--window-ms', type=float, default=500.0)
    ap.add_argument('--lead-s', type=float, default=1.5)
    ap.add_argument('--out', default='chiprun_out/profile_age.json')
    ap.add_argument('--flush', action='store_true',
                    help='a third process: the flush route')
    ap.add_argument('--route', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    ages = [float(a) for a in args.ages.split(',')]
    if args.route:
        import torch
        if not torch.cuda.is_available():
            print('torch_profile_age: no CUDA device', file=sys.stderr)
            return 2
        run(args.route, ages, args.window_ms / 1e3, args.lead_s)
        return 0
    procs = {route: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--route', route,
         '--ages', args.ages, '--window-ms', str(args.window_ms),
         '--lead-s', str(args.lead_s)],
        stdout=subprocess.PIPE, text=True)
        for route in ('sessions', 'kept') + (('flush',) if args.flush
                                             else ())}
    rows, rc = [], 0
    for route, proc in procs.items():
        out, _ = proc.communicate()
        rc = rc or proc.returncode
        rows += [json.loads(line) for line in out.splitlines()
                 if line.startswith('{"route"')]
        rows += [{'route': route, 'age_s': -1, **json.loads(line)}
                 for line in out.splitlines()
                 if line.startswith('{"cupti"')]
    import torch
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    result = {'card': card, 'torch': torch.__version__,
              'window_ms': args.window_ms, 'lead_s': args.lead_s,
              'captures': sorted(rows, key=lambda r: (r['age_s'],
                                                      r['route']))}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    for r in result['captures']:
        print(json.dumps(r))
    print(json.dumps({'card': card, 'torch': torch.__version__}))
    return rc


if __name__ == '__main__':
    sys.exit(main())
