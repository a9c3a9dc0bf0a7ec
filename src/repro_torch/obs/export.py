"""Trace/metrics export: Chrome-trace (Perfetto-loadable) + flat metrics.

Port of ``repro.obs.export`` (the port keeps its own copy).

Two artifacts per traced run, written side by side:

  * ``<base>.trace.json``   — Chrome trace event format (the ``X``
    complete-event flavour plus ``i`` instants for span events and ``M``
    metadata rows naming tracks), loadable directly in Perfetto /
    chrome://tracing.  Track (tid) assignment: spans carrying a ``node``
    attr get that node's track, everything else rides track 0 — so a
    cluster run renders one lane per PM node.
  * ``<base>.metrics.json`` — `MetricsRegistry.to_dict()` (counters,
    gauges, histogram sketches with their percentiles) plus the caller's
    ``meta`` block.

Both files are dumped with ``sort_keys`` and no wall-clock timestamps,
so a deterministic run (seeded streams + `TickClock`) exports
byte-identically.

`python -m repro_torch.obs.report <base>` renders the per-phase latency
table from these files (see `repro_torch.obs.report`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

TRACE_SUFFIX = ".trace.json"
METRICS_SUFFIX = ".metrics.json"


def chrome_trace_events(tracer: Tracer) -> List[dict]:
    """The tracer's spans + events as Chrome trace events."""
    tracks: Dict[str, int] = {}

    def tid_of(span) -> int:
        node = span.attrs.get("node")
        if node is None:
            return 0
        name = str(node)
        if name not in tracks:
            tracks[name] = len(tracks) + 1
        return tracks[name]

    events: List[dict] = []
    for s in tracer.spans:
        tid = tid_of(s)
        args = {k: v for k, v in sorted(s.attrs.items())}
        if s.parent_id is not None:
            args["parent_span"] = s.parent_id
        args["span_id"] = s.span_id
        events.append({
            "name": s.name, "cat": s.name.split(".", 1)[0], "ph": "X",
            "ts": s.t0_us, "dur": s.dur_us, "pid": 0, "tid": tid,
            "args": args,
        })
        for ev in s.events:
            events.append({
                "name": ev["name"], "cat": ev["name"].split(".", 1)[0],
                "ph": "i", "ts": ev["ts_us"], "pid": 0, "tid": tid,
                "s": "t",
                "args": dict(sorted(ev["attrs"].items()),
                             span_id=s.span_id),
            })
    # stable render order: by timestamp then span id (completion order of
    # nested spans is child-first; Perfetto sorts by ts anyway, and a
    # deterministic file needs a deterministic order)
    events.sort(key=lambda e: (e["ts"], e["args"].get("span_id", 0),
                               e["ph"]))
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "main"}}]
    for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": tid, "args": {"name": name}})
    return meta + events


def export_payloads(tracer: Optional[Tracer],
                    registry: Optional[MetricsRegistry],
                    meta: Optional[dict] = None) -> Tuple[dict, dict]:
    """(trace_payload, metrics_payload) — the two artifact bodies."""
    trace = {
        "traceEvents": chrome_trace_events(tracer) if tracer else [],
        "displayTimeUnit": "ns",
        "otherData": dict(meta or {}),
    }
    metrics = {
        "meta": dict(meta or {}),
        "metrics": registry.to_dict() if registry else
        {"counters": {}, "gauges": {}, "histograms": {}},
    }
    return trace, metrics


def write_export(base: str, tracer: Optional[Tracer],
                 registry: Optional[MetricsRegistry],
                 meta: Optional[dict] = None) -> Tuple[str, str]:
    """Write ``<base>.trace.json`` + ``<base>.metrics.json``; returns the
    two paths.  ``base`` may already carry either suffix."""
    for suf in (TRACE_SUFFIX, METRICS_SUFFIX):
        if base.endswith(suf):
            base = base[: -len(suf)]
    trace, metrics = export_payloads(tracer, registry, meta)
    tpath, mpath = base + TRACE_SUFFIX, base + METRICS_SUFFIX
    with open(tpath, "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
    with open(mpath, "w") as f:
        json.dump(metrics, f, indent=1, sort_keys=True)
    return tpath, mpath


def export_strings(tracer: Optional[Tracer],
                   registry: Optional[MetricsRegistry],
                   meta: Optional[dict] = None) -> Tuple[str, str]:
    """The two artifact bodies as canonical JSON strings (the unit the
    byte-identity tests compare)."""
    trace, metrics = export_payloads(tracer, registry, meta)
    return (json.dumps(trace, indent=1, sort_keys=True),
            json.dumps(metrics, indent=1, sort_keys=True))


def load_export(path: str) -> Tuple[Optional[dict], Optional[dict]]:
    """Load (trace, metrics) given a base path or either artifact path;
    a missing sibling loads as None."""
    base = path
    for suf in (TRACE_SUFFIX, METRICS_SUFFIX):
        if base.endswith(suf):
            base = base[: -len(suf)]
    out = []
    for suf in (TRACE_SUFFIX, METRICS_SUFFIX):
        try:
            with open(base + suf) as f:
                out.append(json.load(f))
        except FileNotFoundError:
            out.append(None)
    return out[0], out[1]
