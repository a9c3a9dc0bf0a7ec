"""What the per-layer metric readers under ``metrics/`` share: a mean host
span, a kernel's share of its bandwidth bound, and the device's idle share
of the window.  Each returns None where the run has nothing to read."""

from portbench import counters as C


def mean_span_ms(run, name: str):
    """Mean of the benchmark's host spans ``name``, in ms."""
    spans = run.spans.get(name)
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3


def roofline(run, match, bytes_counter: str):
    """The profiled slice's device time of the kernels ``match`` picks,
    against the bytes ``bytes_counter`` says their launches need at the
    card's HBM rate, in %."""
    if run.trace is None:
        return None
    t = run.trace.device_seconds(match)
    nbytes = run.counters.get(bytes_counter, 0)
    if t <= 0 or not nbytes:
        return None
    return nbytes / C.PEAK_HBM_BYTES_S / t * 100


def device_idle(run):
    """Share of the window in which no device operation ran, in %: the
    profiled slice's device-busy seconds per unit (batch or group) set
    against the window's seconds per unit, so that the profiler's own
    host cost, which slows the profiled units, does not count as idle."""
    t, n = run.trace, run.counters.get("profiled_units", 0)
    units, window = run.facts.get("units", 0), run.facts.get("window_s", 0)
    if t is None or not t.device or not n or not units or window <= 0:
        return None
    return (1 - (t.busy_s() / n) / (window / units)) * 100
