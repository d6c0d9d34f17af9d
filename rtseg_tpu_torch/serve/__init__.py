"""Online inference serving of the port (counterpart of
rtseg_tpu/serve/), each layer its own module:

  * :mod:`engine`   ServeEngine: one CUDA graph a (H, W) bucket, captured
    at construction into a sealed table;
  * :mod:`batcher`  MicroBatcher: bounded queue, max_batch/max_wait_ms
    coalescing, deadline drops, admission backpressure;
  * :mod:`pipeline` ServePipeline: preprocess/postprocess thread pools
    around dispatch and readback threads, two batches in flight;
  * :mod:`server`   stdlib ThreadingHTTPServer front end (POST a PNG ->
    mask; /healthz, /stats, Prometheus-text /metrics, /debug/flight);
  * :mod:`loadgen`  open-loop Poisson load generator and SLO gate
    (tools/torch_segserve.py bench).

Everything here but the engine's replay is host code.
"""

from .batcher import MicroBatcher, Request, ServeDrop, ServeReject
from .engine import (Bucket, Pending, SealedTable, ServeEngine,
                     UnknownBucket, assemble_batch, parse_buckets,
                     select_bucket)
from .loadgen import (bench_http, bench_pipeline, bench_sequential,
                      bench_video, check_report, check_video_report,
                      encode_png, format_report, format_video_report,
                      make_video_payloads, replica_skew, synth_images,
                      synth_video)
from .pipeline import ServePipeline, ServeResult
from .server import (DEADLINE_HEADER, REPLICA_HEADER, VERSION_HEADER,
                     ServeHTTPServer, make_preprocess, make_server)

__all__ = [
    'Bucket', 'Pending', 'SealedTable', 'ServeEngine', 'UnknownBucket',
    'assemble_batch', 'parse_buckets', 'select_bucket',
    'MicroBatcher', 'Request', 'ServeDrop', 'ServeReject',
    'ServePipeline', 'ServeResult',
    'DEADLINE_HEADER', 'REPLICA_HEADER', 'VERSION_HEADER',
    'ServeHTTPServer', 'make_preprocess', 'make_server',
    'bench_http', 'bench_pipeline', 'bench_sequential', 'bench_video',
    'check_report', 'check_video_report', 'encode_png', 'format_report',
    'format_video_report', 'make_video_payloads', 'replica_skew',
    'synth_images', 'synth_video',
]
