"""Runtime telemetry of the port — counters, gauges and fixed-bucket
histograms (``obs.core``), spans with trace context (``obs.trace``) and
the JSONL/Prometheus export with ``/healthz`` (``obs.export``), copied from
``distlearn_tpu/obs``.  Fleet aggregation is not ported yet.

Kill switch: ``DISTLEARN_OBS=0`` makes every factory return a no-op sink.
"""

from distlearn_tpu_torch.obs.core import (NULL, REGISTRY, configure, counter,
                                          enabled, gauge, histogram,
                                          snapshot_record)
from distlearn_tpu_torch.obs.export import (set_health_source,
                                            start_http_server, write_snapshot)
from distlearn_tpu_torch.obs.trace import (TRACE_KEY, new_trace, record_span,
                                           set_process, set_propagate,
                                           set_spill, span, spans, traced,
                                           use_context, wire_context)

__all__ = [
    "NULL", "REGISTRY", "configure", "counter", "enabled", "gauge",
    "histogram", "snapshot_record", "set_health_source",
    "start_http_server", "write_snapshot", "TRACE_KEY", "new_trace",
    "record_span", "set_process", "set_propagate", "set_spill", "span",
    "spans", "traced", "use_context", "wire_context",
]
