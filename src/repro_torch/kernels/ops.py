"""Public wrappers around the kernels.

Port of ``repro.kernels.ops``: ``probe_table`` adapts a ``ContinuityTable``
into the probe kernel's layout (flat contiguous rows + parity priority
table) and returns results identical to ``continuity.lookup``'s probe
stage; ``probe_lookup`` extends it to a FULL lookup (values + extension
slots + stash tail + fetch accounting) and is the continuity store's
kernel read path; ``mutation_plan`` is the write-side peer;
``paged_attention`` is the serving decode step's attention over the page
pool (``merge_partials`` merges its page-token slices' partials).  With ``use_kernel`` the wrappers of ``probe.py``/``mutate.py``/
``paged_attn.py`` run (the CUDA kernel on a card, its plain version on the
CPU); without it the plain versions run directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import continuity as ch
from repro_torch.core.continuity import (KEY_LANES, ContinuityConfig,
                                         ContinuityTable)
from repro_torch.core.words import as_words, u32
from repro_torch.kernels.mutate import mutate_segments
from repro_torch.kernels.mutate_ref import mutate_ref
from repro_torch.kernels.paged_attn import merge_partials  # noqa: F401
from repro_torch.kernels.paged_attn import paged_attention as _paged_attn
from repro_torch.kernels.paged_attn_ref import paged_attention_ref
from repro_torch.kernels.probe import probe_segments
from repro_torch.kernels.probe_ref import probe_ref

BIG = 0x7FFFFFFF
I32 = torch.int32


@functools.lru_cache(maxsize=None)
def priority_table(cfg: ContinuityConfig) -> np.ndarray:
    """(2, SLOTS) probe rank per parity over MAIN slots (ext handled outside).

    Even homes: bucket then SBuckets, left->right. Odd homes: bucket then
    SBuckets, right->left (paper §III-C's directional scans).
    """
    S, bs, seg = cfg.slots_per_pair, cfg.bucket_slots, cfg.seg_slots
    prio = np.full((2, S), BIG, np.int32)
    prio[0, :seg] = np.arange(seg)
    odd_order = list(range(S - 1, bs - 1, -1))
    prio[1, odd_order] = np.arange(seg)
    return prio


def table_rows(table: ContinuityTable) -> torch.Tensor:
    """Main key storage as contiguous per-pair rows (P, SLOTS*KL) — a view."""
    P, S, KL = table.keys.shape
    return table.keys.view(P, S * KL)


def _operands(cfg, table, keys):
    keys = as_words(keys, KEY_LANES, table.keys.device)
    pair, parity = ch.locate(cfg, keys)
    prio = torch.as_tensor(priority_table(cfg), device=keys.device)
    return keys, pair, parity, prio


def probe_table(cfg: ContinuityConfig, table: ContinuityTable, keys,
                *, use_kernel: bool = True, use_fp: bool = False):
    """Probe the main segments of ``table`` for a batch of keys.

    ``use_fp`` enables the fingerprint-word pre-filter (same results:
    visible slots always carry the correct field).  Returns (match_slot,
    empty_slot, pair, parity); slots are -1 on miss/full.
    """
    keys, pair, parity, prio = _operands(cfg, table, keys)
    fps = table.fp if use_fp else None
    qfp = ch.fingerprint(keys).to(I32) if use_fp else None
    fn = probe_segments if use_kernel else probe_ref
    match, empty = fn(table_rows(table), table.indicator[:, None], prio,
                      pair.to(I32), parity.to(I32), keys, fps, qfp)
    return match, empty, pair, parity


def mutation_plan(cfg: ContinuityConfig, table: ContinuityTable, keys,
                  *, use_kernel: bool = True):
    """Resolve the main-segment mutation plan for a batch of keys: the
    MATCH slot, the VICTIM slot (first empty probe candidate) and the
    one-word XOR ``flip`` an uncontended update would store.  Returns
    (match, victim, flip), each (B,) int32, slots -1 on miss/full.
    """
    keys, pair, parity, prio = _operands(cfg, table, keys)
    fn = mutate_segments if use_kernel else mutate_ref
    return fn(table_rows(table), table.indicator[:, None], table.fp, prio,
              pair.to(I32), parity.to(I32), keys,
              ch.fingerprint(keys).to(I32))


def fp_filter_stats(cfg: ContinuityConfig, table: ContinuityTable, keys):
    """Main-segment key compares a probe batch performs with vs without the
    fingerprint pre-filter (the paper's Figs 7/14 quantity), as a host
    dict with both totals and the reduction ratio."""
    keys, pair, parity, prio = _operands(cfg, table, keys)
    S = cfg.slots_per_pair
    iota = torch.arange(S, device=keys.device)[None, :]
    bits = (u32(table.indicator[pair])[:, None] >> iota) & 1
    pr = prio[parity]
    occ = (bits == 1) & (pr < BIG)
    lane = torch.where(iota < 16, u32(table.fp[pair, 0:1]),
                       u32(table.fp[pair, 1:2]))
    field = (lane >> (2 * (iota % 16))) & 3
    pass_fp = occ & (field == ch.fingerprint(keys)[:, None])
    no_fp = int(occ.sum())
    with_fp = int(pass_fp.sum())
    return {
        "queries": int(keys.shape[0]),
        "compares_no_fp": no_fp,
        "compares_with_fp": with_fp,
        "reduction": 1.0 - (with_fp / no_fp if no_fp else 0.0),
    }


def probe_lookup(cfg: ContinuityConfig, table: ContinuityTable, keys,
                 *, use_kernel: bool = True, use_fp: bool = True):
    """Full continuity lookup with the segment-probe kernel as the
    main-segment stage; identical to ``continuity.lookup``.  The extension
    tail (queries whose main segment missed on an extended pair) and the
    stash tail run as plain tensor code, as in the reference."""
    keys = as_words(keys, KEY_LANES, table.keys.device)
    match, _, pair, _ = probe_table(cfg, table, keys, use_kernel=use_kernel,
                                    use_fp=use_fp)
    found_main = match >= 0
    m = match.to(torch.int64)
    vals_main = table.vals[pair, m.clamp(min=0)]
    S = cfg.slots_per_pair
    eidx = table.ext_map[pair].to(torch.int64)
    has_ext = eidx >= 0
    efound, efirst = ch._ext_tail(cfg, table, keys, pair, ~found_main)
    evals = table.ext_vals[eidx.clamp(min=0), efirst]
    found = found_main | efound
    slot = torch.where(found_main, m, torch.where(efound, S + efirst, -1))
    values = torch.where(found_main[:, None], vals_main,
                         torch.where(efound[:, None], evals, 0))
    reads = 1 + (has_ext & ~found_main).to(torch.int64)
    if cfg.stash_slots:
        found, values, slot, reads = ch._stash_tail(
            cfg, table, keys, pair, found, values, slot, reads)
    return ch.LookupResult(found, values, slot.to(I32), pair.to(I32),
                           reads.to(I32))


def paged_attention(q, kpool, vpool, page_table, seq_lens, *,
                    scale: float | None = None, kscale=None, vscale=None,
                    page_stride=None, token_offset=0,
                    use_kernel: bool = True):
    """Paged GQA decode attention: q (B, H, D) over pools (NP, KVH, PS, D)
    through page_table (B, MAXP) with live lengths seq_lens (B,); int8
    pools come with their float32 scales ``kscale``/``vscale`` (NP, KVH,
    PS, 1).  With ``page_stride`` the pools hold a slice of each page's
    tokens from ``token_offset`` on and the call returns the slice's
    partials (``merge_partials`` merges every slice's).  The reference
    pads the query-head group to 8 for the TPU's tiles; the CUDA kernel
    takes any group size, so nothing is padded here."""
    fn = _paged_attn if use_kernel else paged_attention_ref
    kw = {}
    if page_stride is not None:
        kw = dict(page_stride=page_stride, token_offset=token_offset)
        if not use_kernel:
            kw["partials"] = True
    return fn(q, kpool, vpool, page_table, seq_lens, scale=scale,
              kscale=kscale, vscale=vscale, **kw)
