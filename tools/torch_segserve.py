#!/usr/bin/env python
"""Online inference serving of the PyTorch/CUDA port (counterpart of
tools/segserve.py, over rtseg_tpu_torch/serve/).

Usage:
    # HTTP server on the card: POST a PNG to /predict, GET /healthz, /stats
    python tools/torch_segserve.py serve --model bisenetv2 --num_class 19 \
        --ckpt save/best.ckpt --buckets 512x1024,1024x2048 --batch 8 \
        --port 8080

    # open-loop Poisson load test against an in-process pipeline
    python tools/torch_segserve.py bench --model bisenetv2 \
        --buckets 512x1024,1024x2048 --batch 8 --requests 256 --rps 20 \
        --check

    # the same through a real localhost HTTP server (one process)
    python tools/torch_segserve.py bench ... --via-http

    # against an already-running server
    python tools/torch_segserve.py bench ... --http http://host:8080

    # on the CPU, named explicitly (the card is the default)
    python tools/torch_segserve.py bench --device cpu --compute_dtype \
        float32 ...

    # an exported artifact (tools/torch_export.py), no model code
    python tools/torch_segserve.py serve --artifact save/bisenetv2.pt2 \
        --batch 8 --port 8080

The engine captures one CUDA graph a bucket (serve/engine.py). Weights
come from --ckpt (a checkpoint of the port, train/checkpoint.py; an orbax
directory of the JAX package raises) or --artifact (a torch.export
program, export.py: its input shape gives the one bucket and a static
batch, which --batch must match; a symbolic batch takes --batch); with
neither, from Flax's initializers (load generation and capacity tests
only). --obs-dir writes the request, batch and ingress events.

`bench --check` is the gate: exit 1 unless 0 drops, 0 rejections, 0
errors, 0 retraces, one CUDA graph (one eager bucket on the CPU) a
configured bucket, and e2e p95 under --p95-ms.

--compile-cache DIR turns the process's compile cache on under DIR
(rtseg_tpu_torch/warm/): the libraries the server builds (the host
library that decodes request bodies) are loaded from it on the next
start, and the engine gets that cache (its CUDA graphs are still
captured at every start).

--bundle and --stream are the JAX tool's and raise here: registry
bundles and video sessions are not ported (ROADMAP.md Queue 1, "The
planes").

Exit codes: 0 ok, 1 --check failed, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtseg_tpu_torch import obs                                # noqa: E402
from rtseg_tpu_torch.config import SegConfig, not_ported       # noqa: E402
from rtseg_tpu_torch.serve import (ServeEngine, ServePipeline,  # noqa: E402
                                   bench_http, bench_pipeline,
                                   bench_sequential, check_report,
                                   encode_png, format_report,
                                   make_preprocess, make_server,
                                   parse_buckets, synth_images)
from rtseg_tpu_torch.utils import get_colormap                 # noqa: E402


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                   help='the card by default; cpu must be named')
    p.add_argument('--model', default='fastscnn')
    p.add_argument('--num_class', type=int, default=19)
    p.add_argument('--compute_dtype', default=None,
                   help='forward dtype (default bfloat16; float32 on the CPU '
                        'is the usual choice)')
    p.add_argument('--colormap', default='cityscapes')
    p.add_argument('--ckpt', default=None,
                   help='checkpoint of the port to load weights from')
    p.add_argument('--buckets', default='512x1024',
                   help='comma-separated HxW buckets, e.g. 512x1024,256x512')
    p.add_argument('--batch', type=int, default=8,
                   help='fixed batch of every bucket\'s CUDA graph')
    p.add_argument('--max-wait-ms', type=float, default=5.0,
                   help='batcher coalescing window')
    p.add_argument('--max-queue', type=int, default=128,
                   help='admission bound (requests queued before 503)')
    p.add_argument('--deadline-ms', type=float, default=None,
                   help='per-request queue deadline (drop when exceeded)')
    p.add_argument('--workers', type=int, default=2,
                   help='preprocess / postprocess threads each')
    p.add_argument('--no-metrics', action='store_true',
                   help='disable the live metrics registry and request '
                        'tracing')
    p.add_argument('--artifact', default=None,
                   help='torch.export artifact (tools/torch_export.py) to '
                        'serve; the bucket comes from its input shape')
    p.add_argument('--compile-cache', default=None, metavar='DIR',
                   help='compile cache dir: the libraries this process '
                        'builds are stored there and loaded on the next '
                        'start')
    p.add_argument('--bundle', default=None, help='not ported (The planes)')


def _refuse_planes(args) -> None:
    for flag in ('bundle', 'stream'):
        if getattr(args, flag, None):
            raise not_ported(f'--{flag.replace("_", "-")}', 'The planes')


def _build_config(args) -> SegConfig:
    cfg = SegConfig(dataset='synthetic', model=args.model,
                    num_class=args.num_class, colormap=args.colormap,
                    compute_dtype=args.compute_dtype,
                    save_dir=os.path.join(tempfile.gettempdir(),
                                          'torch_segserve'),
                    compile_cache=bool(args.compile_cache),
                    compile_cache_dir=args.compile_cache,
                    use_tb=False)
    cfg.resolve(num_devices=1)
    if cfg.compile_cache:
        from rtseg_tpu_torch.warm import enable_compile_cache
        enable_compile_cache(cfg)
    return cfg


def _build_engine(args, cfg: SegConfig, buckets=None,
                  batch=None) -> ServeEngine:
    if args.artifact:
        from rtseg_tpu_torch.warm.compile_cache import active_cache
        return ServeEngine.from_artifact(
            args.artifact, batch=args.batch if batch is None else batch,
            device=args.device, exe_cache=active_cache())
    return ServeEngine.from_config(
        cfg, buckets or parse_buckets(args.buckets),
        args.batch if batch is None else batch, ckpt_path=args.ckpt,
        device=args.device)


def _build_pipeline(args, cfg: SegConfig,
                    engine: ServeEngine) -> ServePipeline:
    from rtseg_tpu_torch.obs import MetricsRegistry
    return ServePipeline(engine, max_wait_ms=args.max_wait_ms,
                         max_queue=args.max_queue,
                         deadline_ms=args.deadline_ms,
                         preprocess=make_preprocess(cfg),
                         pre_workers=args.workers,
                         post_workers=args.workers,
                         registry=MetricsRegistry(
                             enabled=not args.no_metrics),
                         trace=not args.no_metrics)


def _open_sink(args, **meta):
    if not args.obs_dir:
        return None
    sink = obs.init_run(args.obs_dir, meta={
        'serve': True, 'model': args.model, 'buckets': args.buckets,
        'batch': args.batch, **meta})
    obs.set_sink(sink)
    return sink


def _close_sink(sink) -> None:
    if sink is None:
        return
    sink.emit({'event': 'run_end'})
    sink.close()
    if obs.get_sink() is sink:
        obs.set_sink(None)


def _write_report(args, report: dict) -> None:
    if args.report_json:
        with open(args.report_json, 'w') as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2) if args.json
          else format_report(report), flush=True)


def cmd_serve(args) -> int:
    _refuse_planes(args)
    cfg = _build_config(args)
    engine = _build_engine(args, cfg)
    sink = _open_sink(args)
    pipeline = _build_pipeline(args, cfg, engine)
    server = make_server(pipeline, host=args.host, port=args.port,
                         colormap=get_colormap(cfg),
                         replica_id=args.replica_id,
                         artifact_version=args.artifact_version)
    host, port = server.server_address[:2]
    if args.port_file:
        # --port 0 binds an ephemeral port; write-then-rename so a
        # concurrent reader never sees a half-written file
        tmp = args.port_file + '.tmp'
        with open(tmp, 'w') as f:
            f.write(f'{port}\n')
        os.replace(tmp, args.port_file)
    rid = f' | replica {args.replica_id}' if args.replica_id else ''
    served = args.artifact or cfg.model
    buckets = ','.join(f'{h}x{w}' for h, w in engine.buckets)
    print(f'torch_segserve: {served} on http://{host}:{port}{rid} | '
          f'{engine.device} | buckets {buckets} x batch {engine.batch}'
          f' | POST /predict /drain /debug/flight, GET /healthz /stats '
          f'/metrics', flush=True)
    # SIGTERM = graceful drain: admission stops, in-flight requests finish,
    # then serve_forever returns and the process exits 0
    signal.signal(signal.SIGTERM,
                  lambda *_: server.begin_drain(exit_after=True))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        pipeline.close()
        _close_sink(sink)
    return 0


def cmd_bench(args) -> int:
    _refuse_planes(args)
    targets = list(args.urls or [])
    if args.http:
        targets.append(args.http)
    sink = _open_sink(args, rps_target=args.rps)
    try:
        if targets:
            # external server(s): a urllib client alone, no local engine
            images = synth_images(parse_buckets(args.buckets),
                                  seed=args.seed)
            payloads = [encode_png(im) for im in images]
            report = bench_http(targets, payloads, args.requests, args.rps,
                                seed=args.seed)
            _write_report(args, report)
            if args.check:
                problems = check_report(
                    report, args.p95_ms,
                    max_replica_skew=args.max_replica_skew,
                    expect_replicas=args.expect_replicas)
                if problems:
                    print('torch_segserve check FAILED: '
                          + '; '.join(problems), file=sys.stderr)
                    return 1
            return 0
        cfg = _build_config(args)
        engine = _build_engine(args, cfg)
        buckets = engine.buckets
        images = synth_images(buckets, seed=args.seed)
        if args.via_http:
            pipeline = _build_pipeline(args, cfg, engine)
            server = make_server(pipeline, host='127.0.0.1', port=0,
                                 colormap=get_colormap(cfg))
            port = server.server_address[1]
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            try:
                payloads = [encode_png(im) for im in images]
                report = bench_http(f'http://127.0.0.1:{port}', payloads,
                                    args.requests, args.rps,
                                    seed=args.seed)
            finally:
                server.shutdown()
                server.server_close()
                pipeline.close()
                t.join(timeout=10)
            report['engine'] = engine.stats()
            report['batcher'] = pipeline.batcher.stats()
        else:
            with _build_pipeline(args, cfg, engine) as pipeline:
                report = bench_pipeline(pipeline, images, args.requests,
                                        args.rps, seed=args.seed,
                                        deadline_ms=args.deadline_ms)
        report['device'] = str(engine.device)
        if args.baseline:
            base_engine = _build_engine(args, cfg, buckets=buckets, batch=1)
            report['baseline'] = bench_sequential(
                base_engine, images, min(args.requests,
                                         args.baseline_requests))
        _write_report(args, report)
        if args.check:
            problems = check_report(report, args.p95_ms,
                                    expect_buckets=len(buckets))
            if problems:
                print('torch_segserve check FAILED: ' + '; '.join(problems),
                      file=sys.stderr)
                return 1
            print(f'torch_segserve check OK: {report["ok"]}/'
                  f'{report["requests"]} ok, 0 drops/rejects, p95 '
                  f'{report["e2e_p95_ms"]:.1f} ms <= {args.p95_ms} ms, '
                  f'{len(buckets)} buckets, 0 retraces', flush=True)
        return 0
    finally:
        _close_sink(sink)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='torch_segserve', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)

    sp = sub.add_parser('serve', help='run the HTTP serving front end')
    _add_engine_args(sp)
    sp.add_argument('--host', default='0.0.0.0')
    sp.add_argument('--port', type=int, default=8080,
                    help='0 binds an ephemeral port (printed, and written '
                         'to --port-file)')
    sp.add_argument('--port-file', default=None, metavar='PATH',
                    help='write the bound port here once listening')
    sp.add_argument('--replica-id', default=None,
                    help='identity stamped into every response as '
                         'X-Replica-Id')
    sp.add_argument('--artifact-version', default=None,
                    help='version stamped into every response as '
                         'X-Artifact-Version')
    sp.add_argument('--obs-dir', default=None,
                    help='write ingress/request/batch events here')
    sp.add_argument('--stream', action='store_true',
                    help='video sessions: not ported (The planes)')

    bp = sub.add_parser('bench', help='open-loop Poisson load test')
    _add_engine_args(bp)
    bp.add_argument('--requests', type=int, default=256)
    bp.add_argument('--rps', type=float, default=50.0,
                    help='target arrival rate (open loop)')
    bp.add_argument('--seed', type=int, default=0)
    bp.add_argument('--http', default=None,
                    help='drive an already-running server at this URL')
    bp.add_argument('--url', action='append', dest='urls', default=None,
                    metavar='URL',
                    help='repeatable: drive several running servers '
                         'round-robin; implies HTTP mode')
    bp.add_argument('--max-replica-skew', type=float, default=None,
                    help='--check also gates the per-replica balance')
    bp.add_argument('--expect-replicas', type=int, default=None,
                    help='--check also gates how many X-Replica-Id values '
                         'served traffic')
    bp.add_argument('--via-http', action='store_true',
                    help='start a localhost server in-process and drive it '
                         'over real HTTP')
    bp.add_argument('--baseline', action='store_true',
                    help='also run the closed-loop sequential bs1 baseline '
                         'and report the throughput ratio')
    bp.add_argument('--baseline-requests', type=int, default=64)
    bp.add_argument('--obs-dir', default=None,
                    help='write request/batch events here')
    bp.add_argument('--json', action='store_true')
    bp.add_argument('--report-json', default=None, metavar='PATH',
                    help='also write the report dict to this file')
    bp.add_argument('--check', action='store_true',
                    help='the gate (see the module docstring)')
    bp.add_argument('--p95-ms', type=float, default=1000.0,
                    help='--check e2e p95 threshold')
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return cmd_serve(args) if args.cmd == 'serve' else cmd_bench(args)


if __name__ == '__main__':
    sys.exit(main())
