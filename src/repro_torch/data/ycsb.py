"""YCSB workload generators (Cooper et al., SoCC'10) matching the paper §V-A.

Workloads over 16-byte keys / 16-byte values (paper: 16 B keys, <=15 B
values):
  A: 50% update / 50% read          (update-heavy)
  B: 95% read / 5% update           (read-mostly)
  C: 100% read                      (read-only; positive search)
  D: 95% read / 5% insert, reads target LATEST inserts (read-latest)
  E: 95% scan / 5% insert           (short range scans — the workload
                                     continuity's contiguous SBuckets
                                     are built for: a scan is ONE
                                     contiguous segment-range READ)
  F: 50% read / 50% read-modify-write
plus the paper's microbenchmarks: insert-only, update-only, delete-only,
positive/negative search.

Request distributions: zipfian (theta=0.99, YCSB default) for A/B/C/F,
"latest" for D, uniform for microbenchmarks.  E's scan lengths are
uniform on [1, MAX_SCAN_LEN] (YCSB's uniform default, shortened to keep
sim cells small).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

OP_READ, OP_UPDATE, OP_INSERT, OP_RMW, OP_DELETE, OP_SCAN = 0, 1, 2, 3, 4, 5

MAX_SCAN_LEN = 16       # YCSB-E max scan length (uniform in [1, max])

WORKLOADS = {
    "A": [(OP_READ, 0.5), (OP_UPDATE, 0.5)],
    "B": [(OP_READ, 0.95), (OP_UPDATE, 0.05)],
    "C": [(OP_READ, 1.0)],
    "D": [(OP_READ, 0.95), (OP_INSERT, 0.05)],
    "E": [(OP_SCAN, 0.95), (OP_INSERT, 0.05)],
    "F": [(OP_READ, 0.5), (OP_RMW, 0.5)],
}


def scan_lengths(rng: np.random.RandomState, n: int,
                 max_len: int = MAX_SCAN_LEN) -> np.ndarray:
    """YCSB-E scan lengths: uniform integers in [1, max_len]."""
    return rng.randint(1, max_len + 1, size=n)


def make_key(ids: np.ndarray) -> np.ndarray:
    """64-bit record ids -> (N, 4) uint32 16-byte keys (YCSB 'user###' style:
    deterministic, well-spread)."""
    ids = ids.astype(np.uint64)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (ids >> np.uint64(32)).astype(np.uint32)
    salt = (lo * np.uint32(2654435761)) ^ np.uint32(0xDEADBEEF)
    return np.stack([lo, hi, salt, np.uint32(0x59435342)
                     * np.ones_like(lo)], -1)


def make_value(rng: np.random.RandomState, n: int) -> np.ndarray:
    return rng.randint(0, 2 ** 31, size=(n, 4)).astype(np.uint32)


class Zipf:
    """Gray et al. zipfian generator over [0, n) with theta=0.99 (YCSB)."""

    def __init__(self, n: int, theta: float = 0.99):
        self.n = n
        self.theta = theta
        zetan = np.sum(1.0 / np.arange(1, n + 1) ** theta)
        self.zetan = zetan
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = np.sum(1.0 / np.arange(1, 3) ** theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / zetan)

    def sample(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        u = rng.random_sample(size)
        uz = u * self.zetan
        out = np.where(uz < 1.0, 0,
                       np.where(uz < 1.0 + 0.5 ** self.theta, 1,
                                (self.n * (self.eta * u - self.eta + 1)
                                 ** self.alpha).astype(np.int64)))
        return np.clip(out, 0, self.n - 1)


class Hotspot:
    """YCSB hotspot distribution: ``hot_op_frac`` of requests hit the
    first ``hot_frac`` of the keyspace uniformly, the rest hit the cold
    remainder uniformly (the cluster sim's shard-imbalance stressor)."""

    def __init__(self, n: int, hot_frac: float = 0.2,
                 hot_op_frac: float = 0.8):
        assert 0.0 < hot_frac < 1.0 and 0.0 < hot_op_frac < 1.0
        self.n = n
        self.hot = max(1, int(n * hot_frac))
        self.hot_op_frac = hot_op_frac

    def sample(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        is_hot = rng.random_sample(size) < self.hot_op_frac
        hot_ids = rng.randint(0, self.hot, size=size)
        cold_ids = (rng.randint(0, max(1, self.n - self.hot), size=size)
                    + self.hot) % self.n
        return np.where(is_hot, hot_ids, cold_ids)


def request_stream(dist: str, n: int, *, theta: float = 0.99,
                   hot_frac: float = 0.2, hot_op_frac: float = 0.8):
    """The ONE factory for skewed request streams: every sim (rdma,
    cluster, cache fan-in) builds its stream here so the skew knobs —
    zipf ``theta``, hotspot ``hot_frac``/``hot_op_frac`` — are sweepable
    end to end instead of baked into each caller."""
    if dist == "zipf":
        return Zipf(n, theta=theta)
    assert dist == "hotspot", dist
    return Hotspot(n, hot_frac=hot_frac, hot_op_frac=hot_op_frac)


def stream_self_check(stream, rng: np.random.RandomState,
                      samples: int = 20_000, tol: float = 0.05) -> dict:
    """Tiny distribution audit (the cache tests gate on it): draw
    ``samples`` ranks and compare the measured hot mass to the stream's
    analytic expectation.  Hotspot: the fraction of draws landing inside
    the hot set must match ``hot_op_frac`` (the cold branch never wraps
    into the hot range by construction).  Zipf: the mass on the top 1% of
    ranks must match the partial zeta sum.  A sim whose 'hotspot' is not
    actually hot would silently void every cache claim downstream."""
    ranks = stream.sample(rng, samples)
    if isinstance(stream, Hotspot):
        measured = float((ranks < stream.hot).mean())
        expected = float(stream.hot_op_frac)
    else:
        k = max(1, stream.n // 100)
        measured = float((ranks < k).mean())
        expected = float(np.sum(1.0 / np.arange(1, k + 1) ** stream.theta)
                         / stream.zetan)
    return {"ok": bool(abs(measured - expected) <= tol),
            "measured": measured, "expected": expected, "tol": tol,
            "samples": samples}


@dataclasses.dataclass
class OpBatch:
    ops: np.ndarray     # (B,) int32 op codes
    keys: np.ndarray    # (B, 4) uint32
    vals: np.ndarray    # (B, 4) uint32


def generate(workload: str, num_records: int, num_ops: int,
             batch: int, seed: int = 0,
             theta: float = 0.99) -> Iterator[OpBatch]:
    """Yield op batches for a YCSB workload over a preloaded keyspace of
    ``num_records`` records (load phase is the caller's insert of ids
    [0, num_records)).  ``theta`` sweeps the request-skew exponent."""
    rng = np.random.RandomState(seed)
    mix = WORKLOADS[workload]
    codes = np.array([c for c, _ in mix])
    probs = np.array([p for _, p in mix])
    zipf = Zipf(num_records, theta=theta)
    next_insert = num_records
    done = 0
    while done < num_ops:
        b = min(batch, num_ops - done)
        ops = rng.choice(codes, size=b, p=probs).astype(np.int32)
        if workload == "D":     # read-latest: skew toward newest ids
            lat = next_insert - 1 - zipf.sample(rng, b)
            ids = np.clip(lat, 0, None)
        else:
            ids = zipf.sample(rng, b)
        ins = ops == OP_INSERT
        n_ins = int(ins.sum())
        if n_ins:
            ids = ids.copy()
            ids[ins] = np.arange(next_insert, next_insert + n_ins)
            next_insert += n_ins
        yield OpBatch(ops=ops, keys=make_key(ids),
                      vals=make_value(rng, b))
        done += b


def negative_keys(rng: np.random.RandomState, num_records: int,
                  n: int) -> np.ndarray:
    """Keys guaranteed absent (ids beyond the loaded range)."""
    ids = num_records + 10_000_000 + rng.randint(0, 2 ** 30, size=n)
    return make_key(ids.astype(np.int64))
