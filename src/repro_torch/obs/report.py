"""Render a per-phase latency/throughput table from an obs export.

    python -m repro_torch.obs.report <base|export.trace.json> [--check] [--top N]

Port of ``repro.obs.report``.  Reads the ``<base>.trace.json`` /
``<base>.metrics.json`` pair written by
`repro_torch.obs.export.write_export` and prints:

  * the per-phase SPAN table — every span name with call count, total
    traced time, and p50/p99 span duration (durations aggregated through
    the same `Histogram` sketch the metrics use — the report has no
    second percentile implementation to disagree with);
  * the top-N spans by total time;
  * every metrics histogram with count/mean/p50/p90/p99/p999;
  * the headline ratio: when the export carries per-scheme ``e2e.op_us``
    histograms (a traced `cluster/sim.py --trace` run records the
    YCSB trio), the continuity-vs-pfarm and continuity-vs-level p50
    ratios per workload — the paper's ~1.7x latency ordering.

``--check`` is the gate: exit 1 unless the trace is
non-empty, the metrics payload is schema-valid, the e2e p50 ordering
matches the end-to-end band (full chain continuity <= level <= pfarm
on the write-mixed YCSB-A; continuity <= pfarm on read-only mixes,
where level's shorter probe chains undercut continuity's p50), and
the run recorded ZERO maintenance-SLO burns.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.export import load_export
from repro_torch.obs.metrics import Histogram

_KEY_RE = re.compile(r"^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$")


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"e2e.op_us{op=read,scheme=continuity}"`` -> (name, labels)."""
    m = _KEY_RE.match(key)
    assert m is not None, key
    labels = {}
    if m.group("labels"):
        for part in m.group("labels").split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group("name"), labels


def span_table(trace: dict) -> List[dict]:
    """Aggregate complete-events by span name: count, total, p50/p99."""
    agg: Dict[str, Tuple[Histogram, int]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        h, _ = agg.setdefault(ev["name"], (Histogram(), 0))
        h.record(float(ev.get("dur", 0.0)))
    rows = []
    for name, (h, _) in agg.items():
        rows.append({"span": name, "count": h.count, "total_us": h.total,
                     "p50_us": h.percentile(50), "p99_us": h.percentile(99)})
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def e2e_ratios(metrics: dict) -> Dict[str, Dict[str, float]]:
    """{workload: {scheme: merged p50}} from the e2e.op_us histograms."""
    per: Dict[str, Dict[str, Histogram]] = {}
    hists = metrics.get("metrics", {}).get("histograms", {})
    for key, hd in hists.items():
        name, labels = parse_key(key)
        if name != "e2e.op_us":
            continue
        wl, scheme = labels.get("workload", "?"), labels.get("scheme", "?")
        per.setdefault(wl, {}).setdefault(scheme, Histogram()) \
            .merge(Histogram.from_dict(hd))
    return {wl: {s: h.percentile(50) for s, h in by_s.items()}
            for wl, by_s in per.items()}


def slo_burns(metrics: dict) -> float:
    total = 0.0
    for key, v in metrics.get("metrics", {}).get("counters", {}).items():
        if parse_key(key)[0] == "maintenance.slo_burn":
            total += v
    return total


def _schema_errors(trace: Optional[dict],
                   metrics: Optional[dict]) -> List[str]:
    bad = []
    if trace is None:
        bad.append("trace artifact missing")
    elif not isinstance(trace.get("traceEvents"), list) \
            or not any(e.get("ph") == "X" for e in trace["traceEvents"]):
        bad.append("trace has no complete span events")
    if metrics is None:
        bad.append("metrics artifact missing")
    else:
        m = metrics.get("metrics")
        if not isinstance(m, dict) or \
                set(m) < {"counters", "gauges", "histograms"}:
            bad.append("metrics payload missing counters/gauges/histograms")
        elif not (m["counters"] or m["histograms"]):
            bad.append("metrics payload is empty")
        else:
            for key, hd in m["histograms"].items():
                if not isinstance(hd, dict) or "count" not in hd \
                        or "buckets" not in hd:
                    bad.append(f"histogram {key!r} malformed")
                    break
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", help="export base path (or either artifact)")
    p.add_argument("--top", type=int, default=5,
                   help="spans in the top-by-total-time table")
    p.add_argument("--check", action="store_true",
                   help="gate: non-empty + schema-valid + e2e p50 "
                        "ordering + zero SLO burns")
    args = p.parse_args(argv)
    trace, metrics = load_export(args.path)
    bad = _schema_errors(trace, metrics)

    if trace is not None:
        rows = span_table(trace)
        print(f"{'span':34s} {'count':>7s} {'total_us':>12s} "
              f"{'p50_us':>10s} {'p99_us':>10s}")
        for r in rows:
            print(f"{r['span']:34s} {r['count']:7d} {r['total_us']:12.1f} "
                  f"{r['p50_us']:10.2f} {r['p99_us']:10.2f}")
        print(f"\ntop {args.top} spans by total traced time:")
        for r in rows[:args.top]:
            print(f"  {r['span']:32s} {r['total_us']:12.1f} us "
                  f"({r['count']} calls)")

    if metrics is not None:
        hists = metrics.get("metrics", {}).get("histograms", {})
        if hists:
            print(f"\n{'histogram':52s} {'count':>7s} {'p50':>9s} "
                  f"{'p90':>9s} {'p99':>9s} {'p999':>9s}")
            for key in sorted(hists):
                h = Histogram.from_dict(hists[key])
                print(f"{key:52s} {h.count:7d} {h.percentile(50):9.2f} "
                      f"{h.percentile(90):9.2f} {h.percentile(99):9.2f} "
                      f"{h.percentile(99.9):9.2f}")
        ratios = e2e_ratios(metrics)
        for wl in sorted(ratios):
            by_s = ratios[wl]
            if "continuity" not in by_s:
                continue
            base = by_s["continuity"]
            line = [f"e2e YCSB-{wl} p50: continuity {base:.2f}us"]
            for other in ("level", "pfarm"):
                if other in by_s and base > 0:
                    line.append(f"{other} {by_s[other]:.2f}us "
                                f"({by_s[other] / base:.2f}x)")
            print("\n" + ", ".join(line))
            # the ordering gate: the FULL chain continuity <= level <=
            # pfarm holds on the write-mixed YCSB-A p50; on read-only
            # mixes level probes under continuity's p50, so there only
            # the headline contrast continuity <= pfarm gates
            names = (("continuity", "level", "pfarm") if wl == "A"
                     else ("continuity", "pfarm"))
            chain = [by_s[s] for s in names if s in by_s]
            if any(a > b * (1 + 1e-9) for a, b in zip(chain, chain[1:])):
                bad.append(f"e2e p50 ordering violated on YCSB-{wl}: "
                           f"{by_s}")
        burns = slo_burns(metrics)
        print(f"\nmaintenance SLO burns: {burns:.0f}")
        if burns != 0:
            bad.append(f"{burns:.0f} maintenance steps burned their SLO "
                       f"(must be 0)")

    if args.check:
        for b in bad:
            print(f"FAIL: {b}", file=sys.stderr)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
