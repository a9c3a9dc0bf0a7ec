"""Nested span tracing with injectable clocks and causal links.

Port of ``repro.obs.trace``.  A `Tracer` records a tree of spans (``with
span("rdma.post"):``) plus point-in-time span EVENTS (doorbell rings,
retries, fence waits).  Every span carries its parent's id, taken from
the tracer's span stack at entry.

The default `TickClock` advances a fixed amount per call, so a traced
simulation is a pure function of its call sequence; pass a
``time.perf_counter``-style callable (seconds; the tracer scales to us) to
trace wall time instead.

Instrumented code calls the module-level `span()`/`event()` free
functions, which no-op unless a tracer is installed (`install(tracer)` or
the `scope()` context manager, which also swaps in a fresh metrics
registry and restores both on exit).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry


class TickClock:
    """Deterministic clock: returns ``n * tick_us`` on the n-th call.

    Time is a call counter, not wall time — a span's "duration" counts
    the traced operations that happened inside it, which is exactly the
    reproducible quantity a simulated cluster has (its real latencies
    live in the metrics histograms, priced by the `LinkModel`)."""

    def __init__(self, tick_us: float = 1.0):
        self.tick_us = tick_us
        self.n = 0

    def __call__(self) -> float:
        self.n += 1
        return self.n * self.tick_us


class Span:
    __slots__ = ("span_id", "parent_id", "name", "attrs", "t0_us", "t1_us",
                 "events")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 attrs: Dict[str, Any], t0_us: float):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.t0_us = t0_us
        self.t1_us = t0_us
        self.events: List[dict] = []

    @property
    def dur_us(self) -> float:
        return self.t1_us - self.t0_us


class Tracer:
    """Span recorder.  ``clock`` returns MICROSECONDS when it is a
    `TickClock` (or any callable flagged ``.returns_us = True``), else
    seconds (perf_counter-style) scaled by 1e6."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else TickClock()
        self._scale = 1.0 if isinstance(self.clock, TickClock) \
            or getattr(self.clock, "returns_us", False) else 1e6
        self.spans: List[Span] = []          # finished, in completion order
        self.stack: List[Span] = []
        self._next_id = 1
        self.dropped_events = 0              # events with no open span

    def _now(self) -> float:
        return float(self.clock()) * self._scale

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        s = Span(self._next_id,
                 self.stack[-1].span_id if self.stack else None,
                 name, attrs, self._now())
        self._next_id += 1
        self.stack.append(s)
        try:
            yield s
        finally:
            s.t1_us = self._now()
            self.stack.pop()
            self.spans.append(s)

    def event(self, name: str, **attrs) -> None:
        """Point event attached to the innermost open span.  An event
        with no open span is counted and dropped (never an error: the
        transport fires events from whatever context called it)."""
        if not self.stack:
            self.dropped_events += 1
            return
        self.stack[-1].events.append(
            {"name": name, "ts_us": self._now(), "attrs": attrs})


class _NullSpan:
    """The no-tracer fast path: a reusable no-op context manager."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_TRACER: Optional[Tracer] = None
_REGISTRY = MetricsRegistry()        # the process-local default registry


def install(tracer: Optional[Tracer]) -> None:
    global _TRACER
    _TRACER = tracer


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    old = _REGISTRY
    _REGISTRY = reg
    return old


def span(name: str, **attrs):
    """``with obs.span("cluster.write", op="insert"):`` — no-op (shared
    null context) unless a tracer is installed."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)


@contextlib.contextmanager
def scope(tracer: Optional[Tracer] = None,
          registry: Optional[MetricsRegistry] = None):
    """Install a (tracer, fresh registry) pair for the duration; restores
    the previous pair on exit.  Yields ``(tracer, registry)`` — the CI
    drills run inside one scope and export exactly what it captured."""
    global _TRACER
    tracer = tracer if tracer is not None else Tracer()
    registry = registry if registry is not None else MetricsRegistry()
    prev_t, prev_r = _TRACER, set_registry(registry)
    _TRACER = tracer
    try:
        yield tracer, registry
    finally:
        _TRACER = prev_t
        set_registry(prev_r)
