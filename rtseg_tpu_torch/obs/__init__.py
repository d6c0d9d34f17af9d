"""Runtime telemetry of the port (counterpart of rtseg_tpu/obs/).

Spans, the JSONL event sink and the memory events (core.py), the step
collector (collector.py), the stall watchdog (watchdog.py), run reports
(report.py), the live metrics registry and its Prometheus text
(metrics.py), request trace ids (tracing.py), device-time attribution
over torch.profiler traces with its capture surfaces (profile.py), the
flight recorder (flight.py), trace assembly (trail.py) and the live
poller (live.py). Events land in one JSONL file a process under
``config.obs_dir``; ``tools/torch_segscope.py report|diff|live|trace``
reads them. All APIs are host-side.
"""

from .core import (EventSink, emit_memory, get_sink, init_run,
                   read_memory_stats, set_sink, span, update_memory_gauges)
from .collector import StepCollector
from .watchdog import StallWatchdog, dump_all_stacks
from .report import (diff_table, format_summary, load_events, summarize)
from .metrics import (MetricsRegistry, get_registry, quantiles_of,
                      render_prometheus, set_registry)
from .tracing import TRACE_KEY, ensure_trace, new_trace_id, valid_trace_id
from .profile import (CaptureBusy, DeviceProfile, SampledProfiler,
                      capture_window, parse_trace)
from .flight import FlightRecorder, dump_all, traffic_mix
from .trail import assemble_trace, format_timeline, load_trace

__all__ = [
    'EventSink', 'emit_memory', 'get_sink', 'init_run',
    'read_memory_stats', 'set_sink', 'span', 'update_memory_gauges',
    'StepCollector', 'StallWatchdog', 'dump_all_stacks',
    'diff_table', 'format_summary', 'load_events', 'summarize',
    'MetricsRegistry', 'get_registry', 'set_registry', 'render_prometheus',
    'quantiles_of',
    'TRACE_KEY', 'ensure_trace', 'new_trace_id',
    'valid_trace_id',
    'CaptureBusy', 'DeviceProfile', 'SampledProfiler', 'capture_window',
    'parse_trace',
    'FlightRecorder', 'dump_all', 'traffic_mix',
    'assemble_trace', 'format_timeline', 'load_trace',
]
