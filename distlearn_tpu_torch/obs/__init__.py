"""Runtime telemetry of the port — counters, gauges and fixed-bucket
histograms (``obs.core``), spans with trace context (``obs.trace``), the
JSONL/Prometheus export with ``/healthz`` and ``/snapshot``
(``obs.export``), and the fleet half: snapshot aggregation with mergeable
histograms and a declarative SLO engine (``obs.agg``), copied from
``distlearn_tpu/obs``.  ``distlearn_tpu_torch.tools.diststat`` aggregates
trails into tables, ``tools.tracecat`` stitches them into per-trace
waterfalls, ``tools.autoscaler`` acts on SLO breaches.

Kill switch: ``DISTLEARN_OBS=0`` makes every factory return a no-op sink.
"""

from distlearn_tpu_torch.obs.agg import (Collector, FleetRegistry,
                                         MergeError, SLOEngine)
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
    "start_http_server", "write_snapshot", "Collector", "FleetRegistry",
    "MergeError", "SLOEngine", "TRACE_KEY", "new_trace", "record_span",
    "set_process", "set_propagate", "set_spill", "span", "spans", "traced",
    "use_context", "wire_context",
]
