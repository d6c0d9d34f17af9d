"""Runtime telemetry of the port (counterpart of rtseg_tpu/obs/): the
parts serving and prediction use. Spans and the JSONL event sink
(core.py), the live metrics registry and its Prometheus text
(metrics.py), request trace ids (tracing.py) and the flight recorder
(flight.py). The step collector, stall watchdog, reports, live poller,
trace assembly and the profiler capture are not ported (ROADMAP.md
Queue 1, "The planes")."""

from .core import (EventSink, get_sink, init_run, read_memory_stats,
                   set_sink, span, update_memory_gauges)
from .flight import FlightRecorder, dump_all, traffic_mix
from .metrics import (MetricsRegistry, get_registry, quantiles_of,
                      render_prometheus, set_registry)
from .tracing import TRACE_KEY, ensure_trace, new_trace_id, valid_trace_id

__all__ = [
    'EventSink', 'get_sink', 'init_run', 'read_memory_stats', 'set_sink',
    'span', 'update_memory_gauges',
    'FlightRecorder', 'dump_all', 'traffic_mix',
    'MetricsRegistry', 'get_registry', 'quantiles_of', 'render_prometheus',
    'set_registry',
    'TRACE_KEY', 'ensure_trace', 'new_trace_id', 'valid_trace_id',
]
