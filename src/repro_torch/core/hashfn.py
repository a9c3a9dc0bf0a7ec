"""Vectorized hash functions over 128-bit keys represented as (..., 4) word lanes.

Port of ``repro.core.hashfn``: murmur3-style ``fmix32`` + boost-style lane
combining, bit for bit.  Inputs are int32 word tensors (uint32 bit
patterns) or int64 word values; outputs are int64 values in
``[0, 2**32)`` (see ``repro_torch.core.words``).  Products of two words
wrap mod 2**64 in int64 (as the directory's 64-bit hashing does), which
leaves their low 32 bits exact.
"""

from __future__ import annotations

import torch

from repro_torch.core.words import MASK32, u32

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for word values x and a 32-bit constant c."""
    return (x * c) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return _rotl(x, r) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """The rotation in the low 32 bits, with bits above them left for a
    following product to drop (``_mul32`` keeps the low 32 bits only)."""
    return (x << r) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit mixer."""
    return _fmix(u32(h))


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def hash128(key: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash (..., 4) key lanes -> (...,) word value, murmur3-32 style.

    Used for home-bucket placement (Eq. (1) of the paper: ``hash(k) % N``).
    """
    if key.shape[-1] != 4:
        raise ValueError(f"keys need 4 lanes, got shape {tuple(key.shape)}")
    # each lane's premix is independent of the chain: all four at once
    lanes = _mul32(_rotl(_mul32(u32(key), _C1), 15), _C2).unbind(-1)
    h = lanes[0] ^ ((seed ^ 16) & MASK32)
    for i, lane in enumerate(lanes):
        if i:
            h = h ^ lane
        h = (_rotl(h, 13) * 5 + 0xE6546B64) & MASK32
    return _fmix(h)


def hash128_2(key: torch.Tensor) -> torch.Tensor:
    """Independent second hash (the slot fingerprint's source)."""
    return hash128(key, seed=0x5BD1E995)


def mix_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two words into one well-mixed word (content hashing)."""
    a = u32(a)
    b = u32(b)
    return fmix32(a ^ ((b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2))
                       & MASK32))


def fold_u32(words: torch.Tensor) -> torch.Tensor:
    """Fold (..., L) words into (...,) one word (token-prefix hashing)."""
    h = torch.full(words.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                   device=words.device)
    for i in range(words.shape[-1]):
        h = mix_pair(h, words[..., i])
    return h
