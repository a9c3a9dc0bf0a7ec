"""Telemetry of the port: metric sketches, span tracing, timeline export.

Port of ``repro.obs``: `metrics` (counters, gauges, mergeable log-scale
histogram sketches), `trace` (nested spans with injectable clocks, point
events), `export` (Chrome-trace/Perfetto JSON + flat metrics JSON,
byte-identical for same-seed runs) and `report` (``python -m
repro_torch.obs.report <base> [--check]``: the per-phase latency table and
its gate).

    from repro_torch import obs
    with obs.span("sim.round"):
        obs.event("rdma.doorbell", verbs=3)
        obs.get_registry().counter("rdma.posts").inc()
"""

from repro_torch.obs.export import (METRICS_SUFFIX, TRACE_SUFFIX,
                                    chrome_trace_events, export_payloads,
                                    export_strings, load_export, write_export)
from repro_torch.obs.metrics import (GROWTH, Counter, Gauge, Histogram,
                                     MetricsRegistry, percentiles_from)
from repro_torch.obs.trace import (Span, TickClock, Tracer, event,
                                   get_registry, get_tracer, install, scope,
                                   set_registry, span)

__all__ = [
    "GROWTH", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentiles_from",
    "Span", "TickClock", "Tracer", "event", "get_registry", "get_tracer",
    "install", "scope", "set_registry", "span",
    "METRICS_SUFFIX", "TRACE_SUFFIX", "chrome_trace_events",
    "export_payloads", "export_strings", "load_export", "write_export",
]
