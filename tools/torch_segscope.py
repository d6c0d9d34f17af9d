"""Run-report CLI over the port's obs/ JSONL telemetry (counterpart of
tools/segscope.py, with the same subcommands, flags and exit codes).

Reads the per-rank event streams a run wrote under config.obs_dir
(default save_dir/segscope) and prints the step-time/goodput breakdown,
or compares two runs as a regression table. Serving runs
(tools/torch_segserve.py bench --obs-dir) get a serving section — RPS,
request p50/p95/p99, stage means, drop/reject counts, batch occupancy —
from their request/batch events, and `diff` flags serve-p99/RPS
regressions beside the training rows. Runs with sampled profiling
(`config.profile_every`) or `/debug/profile` captures get a device
section — busy %, per-category (conv/matmul/collective/copy/fusion/infeed)
and per-module device time, attribution coverage, peak device memory —
and `--roofline` (one JSON object a line, {"model", ...} rows) adds an
MFU line (device busy fraction x the model's analytical ceiling). `diff`
grows per-category device regression rows and `--check` turns any
REGRESSED row into exit 1.

Usage (CPU or card alike; it reads files and URLs):
    python tools/torch_segscope.py report save/segscope
    python tools/torch_segscope.py report save/segscope --json
    python tools/torch_segscope.py report save/segscope --check
    python tools/torch_segscope.py report save/segscope --all-runs
    python tools/torch_segscope.py diff runA/segscope runB/segscope [--check]
    python tools/torch_segscope.py live save/segscope
    python tools/torch_segscope.py live http://127.0.0.1:8080 --once \
        --check --p99-ms 500
    python tools/torch_segscope.py trace 4fe2a1b09c3d5e67 serve-obs/

Metric definitions live in rtseg_tpu_torch/obs/report.py. `report`
summarizes the segment after the last run_start marker (resumes append to
the same files); `--all-runs` keeps everything. `live --check` fails on
any stall, any request error, p99 over the --p99-ms threshold, or a
target with no observed activity.

Exit codes: 0 ok, 1 --check failed / regression, 2 usage or missing run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtseg_tpu_torch.obs.live import (MetricsPoller,          # noqa: E402
                                      SinkTailer, check_frame,
                                      format_frame, trigger_flight)
from rtseg_tpu_torch.obs.report import (diff_rows,            # noqa: E402
                                        diff_table, format_summary,
                                        load_events, load_roofline,
                                        summarize)
from rtseg_tpu_torch.obs.trail import (assemble,              # noqa: E402
                                       format_timeline, load_trace)


def _run_live(args) -> int:
    if args.target.startswith(('http://', 'https://')):
        source = MetricsPoller(args.target)
    else:
        source = SinkTailer(args.target, window_s=args.window)
    breach_fired = False
    while True:
        try:
            frame = source.poll()
        except OSError as e:
            print(f'segscope live: {args.target}: {e}', file=sys.stderr)
            return 2
        out = format_frame(frame)
        if args.once:
            print(out)
        else:
            # full-frame repaint: clear + home, like watch(1)
            print('\x1b[2J\x1b[H' + out, flush=True)
        if args.check:
            problems = check_frame(frame, p99_ms=args.p99_ms,
                                   max_hbm_bytes=args.max_hbm_bytes)
            if problems and args.flight_on_breach and not breach_fired:
                # an SLO breach is the live poller's flight
                # trigger — dump each target's recorder once per breach
                # episode (re-armed when a frame comes back clean)
                breach_fired = True
                for u in args.flight_on_breach:
                    try:
                        dump = trigger_flight(u, reason='slo_breach')
                        print(f'  FLIGHT: dumped {dump.get("records")} '
                              f'records from {u} '
                              f'({dump.get("source")})', flush=True)
                    except OSError as e:
                        print(f'  FLIGHT: {u}: {e}', file=sys.stderr)
            elif not problems:
                breach_fired = False
            if problems:
                # a transient empty first frame is not a failure while
                # following; only --once treats it as terminal
                if args.once:
                    print('segscope live check FAILED: '
                          + '; '.join(problems), file=sys.stderr)
                    return 1
                print('  CHECK: ' + '; '.join(problems), flush=True)
            elif args.once:
                print('segscope live check OK')
        if args.once:
            return 0
        time.sleep(args.interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='torch_segscope', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)

    rp = sub.add_parser('report', help='summarize one run')
    rp.add_argument('path', help='obs dir (events-*.jsonl) or one file')
    rp.add_argument('--json', action='store_true',
                    help='machine-readable summary')
    rp.add_argument('--all-runs', action='store_true',
                    help='include events before the last run_start')
    rp.add_argument('--check', action='store_true',
                    help='exit 1 unless goodput > 0, stalls == 0 and at '
                         'least one train step was recorded')
    rp.add_argument('--roofline', default=None, metavar='PATH',
                    help='roofline rows, one JSON object a line '
                         '({"model", ...}); enables the measured-MFU line '
                         '(device busy x analytical ceiling) in the '
                         'device section')

    dp = sub.add_parser('diff', help='compare two runs (A=baseline, B=new)')
    dp.add_argument('a')
    dp.add_argument('b')
    dp.add_argument('--json', action='store_true')
    dp.add_argument('--check', action='store_true',
                    help='exit 1 when any row is REGRESSED (>5% worse; '
                         'includes the per-category device rows)')

    lp = sub.add_parser('live', help='follow a running system (sink dir '
                                     'or /metrics URL)')
    lp.add_argument('target', help='obs dir / events file to tail, or an '
                                   'http(s) URL whose /metrics to poll')
    lp.add_argument('--interval', type=float, default=2.0,
                    help='seconds between frames')
    lp.add_argument('--once', action='store_true',
                    help='render one frame and exit (CI)')
    lp.add_argument('--window', type=float, default=30.0,
                    help='sliding window for sink-mode percentiles/rates')
    lp.add_argument('--check', action='store_true',
                    help='gate: stalls == 0, request errors == 0, some '
                         'activity observed, p99 under --p99-ms')
    lp.add_argument('--p99-ms', type=float, default=None,
                    help='--check request p99 threshold (ms)')
    lp.add_argument('--max-hbm-bytes', type=float, default=None,
                    help='--check peak device memory threshold (bytes, '
                         'from the device_memory_bytes gauges / memory '
                         'events)')
    lp.add_argument('--flight-on-breach', action='append', default=None,
                    metavar='URL',
                    help='POST /debug/flight to this replica/router URL '
                         'when --check detects an SLO breach (repeat for '
                         'several targets; fires once per breach episode)')

    tp = sub.add_parser('trace', help='cross-plane timeline for one '
                                      'trace id')
    tp.add_argument('trace_id', help='16-hex trace id (from X-Trace-Id, '
                                     'a bench report\'s slowest list, or '
                                     'a p99 exemplar)')
    tp.add_argument('dirs', nargs='+',
                    help='sink dirs to search recursively (a fleet obs '
                         'root covers the router + replica-*/ subdirs)')
    tp.add_argument('--json', action='store_true',
                    help='machine-readable timeline')
    args = ap.parse_args(argv)

    try:
        if args.cmd == 'live':
            try:
                return _run_live(args)
            except KeyboardInterrupt:
                return 0
        if args.cmd == 'trace':
            events = load_trace(args.dirs, args.trace_id)
            tl = assemble(events, args.trace_id) if events else None
            if tl is None:
                print(f'segscope trace: no events carry trace id '
                      f'{args.trace_id} under '
                      + ', '.join(args.dirs), file=sys.stderr)
                return 2
            if args.json:
                print(json.dumps(tl, indent=2, default=str))
            else:
                print(format_timeline(tl))
            return 0
        if args.cmd == 'report':
            events = load_events(args.path, last_run=not args.all_runs)
            roofline = (load_roofline(args.roofline)
                        if args.roofline else None)
            s = summarize(events, roofline=roofline)
            if args.json:
                print(json.dumps(s, indent=2, default=str))
            else:
                print(format_summary(s, args.path))
            if args.check:
                ok = (s['goodput'] > 0 and s['stalls'] == 0
                      and s['train_steps'] > 0)
                if not ok:
                    print(f'segscope check FAILED: '
                          f'goodput={s["goodput"]:.4f} '
                          f'stalls={s["stalls"]} '
                          f'train_steps={s["train_steps"]}',
                          file=sys.stderr)
                    return 1
                print(f'segscope check OK: goodput='
                      f'{100 * s["goodput"]:.1f}% > 0, 0 stalls')
            return 0

        sa = summarize(load_events(args.a))
        sb = summarize(load_events(args.b))
        rows = diff_rows(sa, sb)
        if args.json:
            print(json.dumps({'a': sa, 'b': sb, 'rows': rows},
                             indent=2, default=str))
        else:
            print(f'segscope diff — A: {args.a}  B: {args.b}')
            print(diff_table(sa, sb, rows=rows))
        if args.check:
            regressed = [r for r in rows if r['regressed']]
            if regressed:
                print('segscope diff check FAILED: '
                      + '; '.join(f"{r['label']} {r['a']:.2f} -> "
                                  f"{r['b']:.2f}" for r in regressed),
                      file=sys.stderr)
                return 1
            # stderr under --json: stdout is the machine-readable doc
            print('segscope diff check OK: 0 regressed rows',
                  file=sys.stderr if args.json else sys.stdout)
        return 0
    except FileNotFoundError as e:
        print(f'segscope: {e}', file=sys.stderr)
        return 2


if __name__ == '__main__':
    sys.exit(main())
