"""32-bit word conventions of the PyTorch port.

``torch.uint32`` lacks shifts, addition and modulo, so the port keeps every
uint32 field of the reference in an ``int32`` tensor holding the same bit
pattern (table bytes equal the reference layout, and the CUDA kernels read
them as ``uint32``).  Arithmetic on words widens to ``int64`` holding the
unsigned value in ``[0, 2**32)`` and narrows back with ``to_i32``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises rather than falling back
    to the CPU when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned value of a word tensor as int64 in ``[0, 2**32)``."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 word value -> int32 tensor with the same low 32 bits."""
    return (((x + 2 ** 31) & MASK32) - 2 ** 31).to(torch.int32)


def bit(pos: torch.Tensor) -> torch.Tensor:
    """``1 << pos`` as an int64 word value (pos in [0, 32))."""
    return torch.bitwise_left_shift(torch.ones_like(pos, dtype=torch.int64),
                                    pos.to(torch.int64))


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word value (int64 in, int64 out; SWAR)."""
    v = v & MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK32) >> 24


def as_words(x, lanes: int, device) -> torch.Tensor:
    """Keys or values (numpy or torch, any integer dtype) -> contiguous
    ``(B, lanes)`` int32 word tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            t = x
        elif x.dtype == torch.uint32:
            t = x.view(torch.int32)
        else:
            t = to_i32(x.to(torch.int64))
    else:
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype != np.int32:
            a = (a.astype(np.int64) & MASK32).astype(np.uint32).view(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device).reshape(-1, lanes).contiguous()


def batch_words(device, keys, vals=None, mask=None):
    """A write batch on ``device``: ``(keys, vals, active)`` with keys and
    values as (B, 4) int32 words (vals None when not given) and ``active``
    (B,) bool, all-True when ``mask`` is None."""
    keys = as_words(keys, 4, device)
    B = keys.shape[0]
    if vals is not None:
        vals = as_words(vals, 4, device)
    if mask is None:
        active = torch.ones(B, dtype=torch.bool, device=device)
    elif isinstance(mask, torch.Tensor):
        active = mask.reshape(B).to(device=device, dtype=torch.bool)
    else:
        active = torch.from_numpy(
            np.asarray(mask, dtype=bool).reshape(B)).to(device)
    return keys, vals, active
