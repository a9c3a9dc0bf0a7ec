"""`RemoteMemory`: the simulated one-sided transport endpoint.

Port of ``repro.rdma.transport``.  Executes `VerbPlan`s with doorbell
batching against an analytical latency model and accumulates wire
counters.  There is no real NIC here: correctness comes from the schemes'
own lookups; the transport prices WHAT the scheme put on the wire (the
verb plan), the quantity the paper's throughput/latency comparison is
about.  Its times are `LinkModel` outputs, not measurements of any device.

Doorbell batching: all verbs of one ``post()`` that share a dependency
depth coalesce into ONE doorbell ring = one round trip; depth k+1 issues
only after depth k completes.  A batch of B independent lookups costs ONE
RTT regardless of B.

`LinkModel` holds every calibrated constant in one place: RTT, NIC line
rate, PM media bandwidth (asymmetric read/write — Optane), per-WQE
processing, and the remote-persist fence (Kashyap et al., "Correct, Fast
Remote Persistence").  A plan may live on any device: ``post`` copies each
of its fields to the host once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.rdma import verbs as rv


class DeliveryTimeout(RuntimeError):
    """A verb round exhausted its retry budget (every attempt dropped)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-round timeout + capped exponential backoff with jitter.

    A doorbell round whose completion does not arrive within
    ``timeout_us`` is retried after ``backoff_us(attempt)`` of waiting:
    ``base_us * 2**attempt`` capped at ``cap_us``, with a ``jitter``
    fraction of the delay randomized (decorrelates retry storms across
    clients — the rng is injected so runs stay seeded).  Retrying a
    FENCED WRITE round is idempotent by construction: payload stores are
    blind writes and the round's commit is ONE atomic 8-byte indicator
    store, so a replayed prefix can never be observed half-applied.
    After ``max_attempts`` total attempts the round raises
    `DeliveryTimeout` — the caller's failure-suspicion signal.
    """

    timeout_us: float = 50.0
    max_attempts: int = 8
    base_us: float = 4.0
    cap_us: float = 200.0
    jitter: float = 0.5

    def backoff_us(self, attempt: int,
                   rng: Optional[np.random.RandomState] = None) -> float:
        d = min(self.base_us * (2.0 ** attempt), self.cap_us)
        if rng is None or self.jitter <= 0.0:
            return d
        return d * (1.0 - self.jitter + self.jitter * rng.random_sample())


@dataclasses.dataclass
class FaultInjector:
    """Seeded delivery faults for one endpoint (the chaos engine's knob).

    Each doorbell round independently draws one outcome: ``drop`` (the
    round vanishes — the client times out and retries), ``dup`` (the NIC
    delivers the round twice — harmless for reads and for fenced write
    rounds, which are idempotent, but the duplicate's verbs/bytes are
    paid), ``reorder`` (verbs within the round arrive out of post order —
    legal inside one doorbell, no intra-round ordering is guaranteed, but
    the completion is skewed by one extra RTT), or clean delivery.
    Deterministic given the seed and call order.
    """

    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)
        self.injected = {"drop": 0, "dup": 0, "reorder": 0}

    def draw(self) -> str:
        u = self.rng.random_sample()
        for kind, p in (("drop", self.drop_p), ("dup", self.dup_p),
                        ("reorder", self.reorder_p)):
            if u < p:
                self.injected[kind] += 1
                return kind
            u -= p
        return "ok"


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Analytical RDMA + PM cost constants (microseconds / bytes-per-us).

    Defaults are calibrated to the paper's testbed class (ConnectX-class
    RNIC + Optane DCPMM): ~2 us one-sided RTT, 12 GB/s NIC line rate,
    asymmetric PM media bandwidth, sub-us WQE processing, and a
    remote-persist fence priced as a small dependent flush."""

    rtt_us: float = 2.0              # doorbell ring -> completion, one round
    nic_bytes_per_us: float = 12_000.0   # NIC line rate (12 GB/s)
    pm_read_bytes_per_us: float = 2_500.0    # PM media random read (2.5 GB/s
    #                                          — DCPMM 256 B access granule)
    pm_write_bytes_per_us: float = 2_000.0   # PM media write (2 GB/s)
    verb_us: float = 0.4             # per-WQE NIC/doorbell processing
    fence_us: float = 0.5            # remote-persist flush (RAW read)

    def verb_cost_us(self, verb: np.ndarray, nbytes: np.ndarray,
                     fence: np.ndarray) -> np.ndarray:
        """Element-wise service cost of each verb (RTT excluded — that is
        per round, not per verb)."""
        nbytes = nbytes.astype(np.float64)
        is_read = verb == rv.READ
        is_write = (verb == rv.WRITE) | (verb == rv.CAS)
        active = verb != rv.NOOP
        media = np.where(is_read, nbytes / self.pm_read_bytes_per_us,
                         np.where(is_write,
                                  nbytes / self.pm_write_bytes_per_us, 0.0))
        wire = np.where(active, nbytes / self.nic_bytes_per_us, 0.0)
        return (active * self.verb_us + wire + media
                + (fence & is_write) * self.fence_us)

    def cohort_move_us(self, read_bytes: float, write_bytes: float,
                       verbs: int = 4, fences: int = 3) -> float:
        """Stall cost of relocating ONE resize cohort (one bucket-pair row):
        read the source row, write its items + the new indicator words, CAS
        the cutover token — one dependent round on the wire plus the verb /
        media / fence service times (the unit a resize step's stall budget
        is divided by)."""
        wire = (read_bytes + write_bytes) / self.nic_bytes_per_us
        media = (read_bytes / self.pm_read_bytes_per_us
                 + write_bytes / self.pm_write_bytes_per_us)
        return (self.rtt_us + verbs * self.verb_us + wire + media
                + fences * self.fence_us)


class Completion(NamedTuple):
    """Result of one ``post()`` (one client batch through the transport).

    ``batch_us``   simulated wall time of the whole doorbell-batched post;
    ``op_us``      (B,) unloaded per-op latency (the op alone on the wire:
                   one RTT per dependent round plus its own verb costs —
                   the paper's latency-figure quantity);
    ``rounds``     dependent round trips (doorbells rung);
    ``verbs``      active verbs posted;
    ``bytes``      wire payload moved.
    """

    batch_us: float
    op_us: np.ndarray
    rounds: int
    verbs: int
    bytes: int


class RemoteMemory:
    """One simulated RNIC endpoint + remote PM region set.

    Host-side and stateful (aggregate counters): drive it with the plans
    the stores return (`OpResult.plan`).
    """

    def __init__(self, link: Optional[LinkModel] = None,
                 faults: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.link = link or LinkModel()
        self.faults = faults
        # faults without a retry policy would silently lose rounds; the
        # default policy makes every drop a timeout + backoff + replay
        self.retry = retry or (RetryPolicy() if faults is not None else None)
        # every wire counter lives in the endpoint's registry; the legacy
        # attribute API (``mem.doorbells`` etc.) survives as properties
        # reading it, and ``stats()`` is a view over the same sinks
        self.metrics = registry if registry is not None else MetricsRegistry()
        # callers label posts ("lookup", "validate", "fill", ...) so the
        # cache benchmarks can separate validation traffic from miss
        # traffic on ONE endpoint; first-seen order keeps by_tag stable
        self._tags: list = []

    def _count(self, name: str, n: float = 1,
               tag: Optional[str] = None) -> None:
        self.metrics.counter(name).inc(n)
        if tag is not None:
            self.metrics.counter(name, tag=tag).inc(n)

    # ---- legacy counter attributes, now registry views -------------------
    @property
    def total_us(self) -> float:
        return self.metrics.value("rdma.simulated_us")

    @property
    def posts(self) -> int:
        return int(self.metrics.value("rdma.posts"))

    @property
    def doorbells(self) -> int:
        return int(self.metrics.value("rdma.doorbells"))

    @property
    def total_verbs(self) -> int:
        return int(self.metrics.value("rdma.verbs"))

    @property
    def total_bytes(self) -> int:
        return int(self.metrics.value("rdma.bytes"))

    @property
    def retries(self) -> int:
        """Rounds replayed after a timeout."""
        return int(self.metrics.value("rdma.retries"))

    @property
    def timeouts(self) -> int:
        """Dropped deliveries waited out."""
        return int(self.metrics.value("rdma.timeouts"))

    @property
    def duplicates(self) -> int:
        """Rounds the NIC delivered twice."""
        return int(self.metrics.value("rdma.duplicates"))

    @property
    def reorders(self) -> int:
        """Intra-round reordered deliveries."""
        return int(self.metrics.value("rdma.reorders"))

    @property
    def backoff_us(self) -> float:
        """Total backoff waited before replays."""
        return self.metrics.value("rdma.backoff_us")

    @property
    def give_ups(self) -> int:
        """Rounds that exhausted max_attempts."""
        return int(self.metrics.value("rdma.give_ups"))

    @property
    def by_tag(self) -> dict:
        """Per-tag wire counters incl. per-tag retries/timeouts (so cache
        validate retries are attributable apart from write retries)."""
        v = self.metrics.value
        out = {}
        for t in self._tags:
            out[t] = {
                "posts": int(v("rdma.posts", tag=t)),
                "doorbells": int(v("rdma.doorbells", tag=t)),
                "verbs": int(v("rdma.verbs", tag=t)),
                "bytes": int(v("rdma.bytes", tag=t)),
                "simulated_us": v("rdma.simulated_us", tag=t),
                "retries": int(v("rdma.retries", tag=t)),
                "timeouts": int(v("rdma.timeouts", tag=t)),
            }
        return out

    @classmethod
    def from_policy(cls, policy, link: Optional[LinkModel] = None,
                    faults: Optional[FaultInjector] = None,
                    retry: Optional[RetryPolicy] = None
                    ) -> Optional["RemoteMemory"]:
        """Transport selection threaded through `api.ExecPolicy`: returns an
        endpoint for ``transport="sim"``, None for ``transport="none"``."""
        if getattr(policy, "transport", "none") == "none":
            return None
        return cls(link, faults=faults, retry=retry)

    def _deliver_round(self, round_cost_us: float,
                       tag: Optional[str] = None) -> float:
        """One doorbell round through the fault/retry loop: returns the
        simulated time the round took (clean = RTT + service; each drop
        adds a timeout + backoff; a duplicate pays the service twice; a
        reorder skews completion by one RTT).  Raises `DeliveryTimeout`
        when ``retry.max_attempts`` deliveries all dropped.  ``tag``
        attributes retry/timeout counts to the post's traffic class."""
        clean = self.link.rtt_us + round_cost_us
        if self.faults is None:
            return clean
        assert self.retry is not None
        spent = 0.0
        for attempt in range(self.retry.max_attempts):
            outcome = self.faults.draw()
            if outcome == "drop":
                self._count("rdma.timeouts", tag=tag)
                self._count("rdma.retries", tag=tag)
                back = self.retry.backoff_us(attempt, self.faults.rng)
                self._count("rdma.backoff_us", back)
                obs.event("rdma.retry", attempt=attempt, tag=tag or "",
                          backoff_us=round(back, 3))
                spent += self.retry.timeout_us + back
                continue
            if outcome == "dup":
                self._count("rdma.duplicates")
                return spent + clean + round_cost_us   # second copy drains too
            if outcome == "reorder":
                self._count("rdma.reorders")
                return spent + clean + self.link.rtt_us
            return spent + clean
        self._count("rdma.give_ups", tag=tag)
        obs.event("rdma.give_up", tag=tag or "",
                  attempts=self.retry.max_attempts)
        raise DeliveryTimeout(
            f"round dropped {self.retry.max_attempts} times "
            f"(waited {spent:.1f}us)")

    def post(self, plan: rv.VerbPlan, tag: Optional[str] = None) -> Completion:
        """Execute one doorbell-batched verb plan; returns its `Completion`
        and folds it into the endpoint's aggregate counters.  With a
        `FaultInjector` attached, every dependent round runs the
        timeout/backoff/replay loop — a `DeliveryTimeout` propagates to
        the caller with the endpoint's clock already advanced (the wait
        happened on the wire whether or not the round landed).  ``tag``
        additionally buckets the post's wire counters under
        ``stats()["by_tag"][tag]``."""
        verb, nbytes, depth, fence = (
            f.cpu().numpy() if hasattr(f, "cpu") else np.asarray(f)
            for f in (plan.verb, plan.nbytes, plan.depth, plan.fence))
        active = verb != rv.NOOP
        cost = self.link.verb_cost_us(verb, nbytes, fence)    # (B, M)

        rounds = int((depth + 1)[active].max()) if active.any() else 0
        traced = obs.get_tracer() is not None
        is_write = (verb == rv.WRITE) | (verb == rv.CAS)
        batch_us = 0.0
        try:
            for d in range(rounds):
                sel = active & (depth == d)
                if sel.any():
                    batch_us += self._deliver_round(float(cost[sel].sum()),
                                                    tag=tag)
                    if traced:
                        obs.event("rdma.doorbell", round=d,
                                  verbs=int(sel.sum()), tag=tag or "")
                        nf = int((fence & is_write & sel).sum())
                        if nf:
                            obs.event("rdma.fence_wait", n=nf, round=d,
                                      tag=tag or "")
        except DeliveryTimeout:
            self._count("rdma.simulated_us", batch_us, tag=tag)
            self._count("rdma.posts", tag=tag)
            self._note_tag(tag)
            raise

        # unloaded per-op latency: each op pays one RTT per round it
        # participates in, plus its own verb service costs
        op_rounds = np.where(active, depth + 1, 0).max(axis=1)
        op_us = op_rounds * self.link.rtt_us + (cost * active).sum(axis=1)

        nverbs = int(active.sum())
        nb = int(nbytes[active].sum())
        self._count("rdma.simulated_us", batch_us, tag=tag)
        self._count("rdma.posts", tag=tag)
        self._count("rdma.doorbells", rounds, tag=tag)
        self._count("rdma.verbs", nverbs, tag=tag)
        self._count("rdma.bytes", nb, tag=tag)
        self._note_tag(tag)
        # flush-boundary histogram feed: one record_many per post, never
        # per verb (DESIGN.md §13) — per-tag latency tails come for free
        lbl = {"tag": tag} if tag is not None else {}
        self.metrics.histogram("rdma.op_us", **lbl).record_many(op_us)
        self.metrics.histogram("rdma.post_us", **lbl).record(batch_us)
        self.metrics.histogram("rdma.rounds_per_post", **lbl).record(rounds)
        return Completion(batch_us, op_us, rounds, nverbs, nb)

    def _note_tag(self, tag: Optional[str]) -> None:
        if tag is not None and tag not in self._tags:
            self._tags.append(tag)

    def stats(self) -> dict:
        """A view over the endpoint registry — shape unchanged from the
        pre-registry counters (callers index it blindly)."""
        out = {
            "posts": self.posts,
            "doorbells": self.doorbells,
            "verbs": self.total_verbs,
            "bytes": self.total_bytes,
            "simulated_us": self.total_us,
        }
        # the retry counters outlive the injector: an audit phase that
        # quiesces fault injection still reports what the run survived
        if self.faults is not None or self.retries or self.duplicates \
                or self.reorders or self.give_ups:
            out["retries"] = self.retries
            out["timeouts"] = self.timeouts
            out["duplicates"] = self.duplicates
            out["reorders"] = self.reorders
            out["backoff_us"] = self.backoff_us
            out["give_ups"] = self.give_ups
            if self.faults is not None:
                out["injected"] = dict(self.faults.injected)
        by_tag = self.by_tag
        if by_tag:
            out["by_tag"] = by_tag
        return out
