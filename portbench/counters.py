"""The yardstick's arithmetic: peaks, and the bytes and FLOPs work needs.

Copied from ``chip_smoke.py`` (the segment-probe bound of its kernel
phase, ``_attn_bytes``) and kept here, where a change to the program
cannot move them.  ``home_pairs`` is a copy of the port's
``core/hashfn.hash128`` and Eq. (1) of the paper (``hash(k) % N``), used
only to count the distinct rows a probe batch needs.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM5 data sheet, dense rates, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    return (x * c) & MASK32


def _rotl(x, r):
    return (x << r) | (x >> (32 - r))


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash128(keys: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 key words -> (...,) int64 in [0, 2**32): murmur3-32
    over the four lanes, seed 0 (the table's home-bucket hash)."""
    lanes = _mul32(_rotl(_mul32(keys.to(torch.int64) & MASK32, 0xCC9E2D51),
                         15), 0x1B873593).unbind(-1)
    h = lanes[0] ^ 16
    for i, lane in enumerate(lanes):
        if i:
            h = h ^ lane
        h = (_rotl(h, 13) * 5 + 0xE6546B64) & MASK32
    return _fmix(h)


def home_pairs(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Each key's home segment pair: bucket ``hash(k) % N``, pair = bucket
    // 2."""
    return (hash128(keys) % num_buckets) >> 1


def probe_bytes(queries: int, distinct_rows: int, slots_per_pair: int,
                out_bytes: int) -> int:
    """Bytes one segment-probe launch needs: per distinct pair one row of
    ``slots_per_pair`` 16-byte keys with its 4-byte indicator and 8-byte
    fingerprint word; per query its key, pair, parity and fingerprint (16
    + 4 + 4 + 4) and its outputs (8 B for a lookup's match and empty
    slots, 12 B for a mutation plan's match, victim and flip)."""
    return (distinct_rows * (slots_per_pair * 16 + 4 + 8)
            + queries * (16 + 4 + 4 + 4 + out_bytes))


ATTN_ITEM = {"bf16": 2, "float32": 4, "int8": 1}   # bytes per K/V value


def attn_bytes(mode: str, B: int, H: int, KVH: int, D: int, MAXP: int,
               last: int) -> int:
    """The bytes a decode attention step must move in ``mode`` (the K/V
    pools' dtype): each live token's K and V rows once, with their float32
    scales when int8; q and out (float32 in the float32 mode, else bf16);
    the page table and the lengths."""
    scales = 2 * 4 if mode == "int8" else 0
    q_item = 4 if mode == "float32" else 2
    return (B * last * KVH * (2 * D * ATTN_ITEM[mode] + scales)
            + 2 * B * H * D * q_item + B * MAXP * 4 + B * 4)


def layer_matmul_flops(cfg: dict) -> int:
    """FLOPs of one token through one decoder layer's matmuls (q, k, v, o
    and the SwiGLU gate, up and down projections)."""
    E, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = E // H
    return 2 * (E * H * D + 2 * E * KVH * D + H * D * E + 3 * E * F)


def causal_attn_flops(cfg: dict, first: int, count: int) -> int:
    """FLOPs of one sequence's attention for the query positions
    [first, first + count) over all earlier positions and itself: QK^T
    and PV over the lower triangle only, every layer."""
    E, H = cfg["hidden_size"], cfg["num_attention_heads"]
    D = E // H
    keys = count * first + count * (count + 1) // 2
    return 4 * H * D * keys * cfg["num_hidden_layers"]


def group_flops(cfg: dict, requests: int, prompt_len: int,
                output_tokens: int) -> int:
    """FLOPs a group of requests needs: the prompt's tokens through every
    layer with causal attention and the output head at its last position
    only; then each further served token (``output_tokens - 1`` decode
    steps, the first token comes from the prompt's logits) through every
    layer, attending over its context, with the output head."""
    L, E, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    head = 2 * E * V
    steps = output_tokens - 1
    per_seq = (prompt_len * L * layer_matmul_flops(cfg)
               + causal_attn_flops(cfg, 0, prompt_len) + head
               + steps * (L * layer_matmul_flops(cfg) + head)
               + causal_attn_flops(cfg, prompt_len, steps))
    return requests * per_seq
