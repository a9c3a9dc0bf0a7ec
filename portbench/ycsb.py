"""YCSB draws on the device (Cooper et al., SoCC'10), the benchmark's own copy.

A frozen copy of the port's ``repro_torch/data/ycsb.py`` (Gray et al.'s
zipfian generator at theta 0.99, ``make_key``, ``make_value``,
``negative_keys``), rewritten to draw on the device from a
``torch.Generator`` with the same distributions.  The keys are the same
16-byte words as the port's generator makes for the same record ids; the
values and request ids are other draws of the same distributions.  Later
changes to the program cannot move these draws.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF
KEY_SALT = 0x59435342          # "YCSB": the keys' last lane
NEG_OFFSET = 10_000_000        # absent ids start this far past the records


def words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors holding the same bits."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(I32)


def make_key(ids: torch.Tensor) -> torch.Tensor:
    """int64 record ids -> (N, 4) int32 key words (16-byte keys)."""
    ids = ids.to(I64)
    lo = ids & MASK32
    hi = (ids >> 32) & MASK32
    salt = ((lo * 2654435761) & MASK32) ^ 0xDEADBEEF
    return torch.stack([words(lo), words(hi), words(salt),
                        words(torch.full_like(lo, KEY_SALT))], -1)


def key_ids(keys: torch.Tensor) -> torch.Tensor:
    """The record id a key was made from (lanes 0 and 1), int64."""
    k = keys.to(I64) & MASK32
    return k[:, 0] | (k[:, 1] << 32)


def make_value(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 4) int32 value words, each uniform in [0, 2**31)."""
    return torch.randint(0, 2 ** 31, (n, 4), generator=gen,
                         device=gen.device, dtype=I64).to(I32)


def negative_ids(gen: torch.Generator, num_records: int, n: int):
    """Ids guaranteed absent (beyond the loaded range), int64."""
    return num_records + NEG_OFFSET + torch.randint(
        0, 2 ** 30, (n,), generator=gen, device=gen.device, dtype=I64)


class Zipf:
    """Gray et al.'s zipfian generator over [0, n), theta 0.99 (YCSB)."""

    def __init__(self, n: int, theta: float, device):
        self.n, self.theta = n, theta
        zetan = torch.zeros((), dtype=torch.float64, device=device)
        step = 1 << 24
        for s in range(1, n + 1, step):
            r = torch.arange(s, min(s + step, n + 1), dtype=torch.float64,
                             device=device)
            zetan += (1.0 / r ** theta).sum()
        self.zetan = float(zetan)
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = 1.0 + 0.5 ** theta
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / self.zetan)

    def sample(self, gen: torch.Generator, size: int) -> torch.Tensor:
        u = torch.rand(size, generator=gen, device=gen.device,
                       dtype=torch.float64)
        uz = u * self.zetan
        tail = (self.n * (self.eta * u - self.eta + 1) ** self.alpha).to(I64)
        out = torch.where(uz < 1.0, 0,
                          torch.where(uz < 1.0 + 0.5 ** self.theta, 1, tail))
        return out.clamp(0, self.n - 1)

    def top_mass(self, k: int) -> float:
        """Analytic share of draws on ranks [0, k): the partial zeta sum."""
        r = torch.arange(1, k + 1, dtype=torch.float64)
        return float((1.0 / r ** self.theta).sum()) / self.zetan


class Uniform:
    """YCSB's ``requestdistribution=uniform`` over [0, n)."""

    def __init__(self, n: int):
        self.n = n

    def sample(self, gen: torch.Generator, size: int) -> torch.Tensor:
        return torch.randint(0, self.n, (size,), generator=gen,
                             device=gen.device, dtype=I64)


def distribution(name: str, n: int, device, theta: float = 0.99):
    if name == "zipfian":
        return Zipf(n, theta, device)
    if name == "uniform":
        return Uniform(n)
    raise ValueError(f"unknown request distribution {name!r}")
