"""The benchmark's engine: finds a cell's files by name and runs it.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness loads ``portbench/configs/<config>.json`` and
``portbench/traffic/<traffic>.json``, runs the runner the configuration
names (``portbench/runners/<runner>.py``), and reads each per-layer metric
of the cell with its own reader (``portbench/metrics/<metric>.py``).  A
new configuration, mix or metric is new files and new entries; nothing
here changes.

A runner's ``run(cell)`` sets up, measures for ``cell.seconds``, reads the
device's memory peak, frees the program's state and then holds what the
window produced against its plain reference.  It records host spans and
counters in ``cell.rec`` and, in a traced run, one profiled slice after
the window (``profile_slice``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILER_OWN = {"Activity Buffer Request"}   # the profiler's own host work


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def config_file(config: dict) -> Path:
    return ROOT / config["file"]


def traffic_file(name: str) -> Path:
    return PKG / "traffic" / f"{name}.json"


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` loaded by its path (metric names hold
    dots)."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Recorder:
    """Host spans (seconds) and counters the runners record."""

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value


@dataclasses.dataclass
class Trace:
    """One profiled slice: its length on the host clock, and its device
    and host events as ``(name, start_s, end_s)`` on one timeline."""

    window_s: float
    device: list
    host: list

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (overlaps once)."""
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.device if match(n))

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([k[:120], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time, summed by what the host was doing in each gap
        (the innermost harness label and host operation at its middle)."""
        import heapq
        ev = sorted(self.device, key=lambda e: e[1])
        if not ev:
            return []
        t0 = min([a for _, a, _ in self.host] + [ev[0][1]])
        gaps, end = [], t0
        for _, a, b in ev:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if t0 + self.window_s > end:
            gaps.append((end, t0 + self.window_s))
        host = sorted(self.host, key=lambda h: h[1])
        active, i, tot = [], 0, {}
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], i))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            cover = sorted((host[j][2] - host[j][1], host[j][0])
                           for _, j in active)
            labels = [nm for _, nm in cover if nm.startswith("portbench.")]
            ops = [nm for _, nm in cover if not nm.startswith("portbench.")]
            key = "/".join(x for x in (labels[0] if labels else "",
                                       ops[0] if ops else "python") if x)
            tot[key] = tot.get(key, 0.0) + (b - a)
        return sorted(([k[:120], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def _events(prof) -> list:
    """(name, is_device, start_s, end_s) of every event the profiler kept,
    from its raw events (``prof.events()`` builds a call tree first, which
    took minutes on one served group)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e9, e.end_ns() / 1e9)
            for e in prof.profiler.kineto_results.events()]


def profile_slice(fn: Callable[[], None]) -> Trace:
    """``fn()`` under ``torch.profiler`` with device activity: the slice's
    events on one timeline, clipped to the slice (marked by the
    ``portbench.slice`` label)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("portbench.slice"):
            t0 = time.perf_counter()
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    dev, host, lo = [], [], None
    for name, on_device, a, b in _events(prof):
        if name.startswith("portbench."):
            if name == "portbench.slice" and not on_device:
                lo = a
            if on_device:
                continue    # a label's range on the device's timeline
        if on_device:
            dev.append((name, a, b))
        elif name not in PROFILER_OWN:
            host.append((name, a, b))
    if lo is not None:
        hi = lo + window
        dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev
               if b > lo and a < hi]
        host = [h for h in host if h[2] > lo and h[1] < hi]
    return Trace(window_s=window, device=dev, host=host)


def label(name: str):
    """A host label the profiled slice's idle gaps are attributed to."""
    from torch.profiler import record_function
    return record_function(f"portbench.{name}")


@dataclasses.dataclass
class Cell:
    """What a runner gets: the cell's names and files, the run's arguments,
    and where to record."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    rec: Recorder
    plant: tuple = ()


@dataclasses.dataclass
class Check:
    """One number compared: ``ok`` when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a runner returns: the end-to-end values, the counts, the
    device's numbers, the checks and (traced) the profiled slice."""

    e2e: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list
    trace: Optional[Trace] = None
    facts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader gets."""

    workload: str
    config: dict
    traffic: dict
    spans: dict
    counters: dict
    trace: Optional[Trace]
    e2e: dict
    facts: dict


def device_info(device: torch.device, peak: int, trace) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    if trace is not None:
        info.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, *, t_start: float, bench: Optional[dict] = None,
             overrides: Optional[dict] = None,
             plant=(), with_facts: bool = False) -> dict:
    """Run one cell and return its result line (a dict).  ``overrides``
    replace configuration and traffic values (the CPU tests' small
    sizes); ``plant`` plants a fault or a control under the runner;
    ``with_facts`` adds the runner's facts (counts, the control's reading)
    and counters under ``facts``."""
    bench = bench or manifest()
    w = find(bench["workloads"], workload, "workload")
    c = find(bench["configs"], w["config"], "config")
    config = load_json(config_file(c))
    traffic = load_json(traffic_file(w["traffic"]))
    for key, val in (overrides or {}).get("config", {}).items():
        config[key] = val
    for key, val in (overrides or {}).get("traffic", {}).items():
        traffic[key] = val
    rec = Recorder()
    cell = Cell(workload, config, traffic, seed, seconds, trace,
                torch.device(device), rec, tuple(plant))
    runner = module("runners", config["runner"])
    out = runner.run(cell, t_start=t_start)

    e2e_specs = [m for m in bench["end_to_end"]
                 if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e_specs}
    metrics = {}
    if not trace:
        for m in e2e_specs:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        view = RunView(workload, config, traffic, rec.spans, rec.counters,
                       out.trace, out.e2e, out.facts)
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]) or \
                    m["moves"] not in reported:
                continue
            value = module("metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": all(ch.ok for ch in out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": device_info(cell.device, out.memory_peak_bytes,
                              out.trace if trace else None),
    }
    if trace and out.trace is not None and out.trace.device:
        line["breakdown"] = {"device_ops": out.trace.top_ops(),
                             "idle_gaps": out.trace.idle_gaps()}
    if with_facts:
        line["facts"] = dict(out.facts, counters=rec.counters,
                             spans={k: [sum(v), len(v), min(v), max(v)]
                                    for k, v in rec.spans.items()})
    line["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit}
                      for ch in out.checks}
    return line
