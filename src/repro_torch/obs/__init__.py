"""Telemetry of the port: metric sketches and span tracing.

Port of the part of ``repro.obs`` that the transport and the simulator
use: `metrics` (counters, gauges, mergeable log-scale histogram sketches)
and `trace` (nested spans with injectable clocks, point events).  The
reference's ``export`` (Perfetto / metrics JSON) and ``report`` are not
ported yet.

    from repro_torch import obs
    with obs.span("sim.round"):
        obs.event("rdma.doorbell", verbs=3)
        obs.get_registry().counter("rdma.posts").inc()
"""

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
]
