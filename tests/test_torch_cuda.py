"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly (the serial walk: every table field,
``ok`` and ``pm``); attention outputs within the tolerances of
``tests/test_kernels.py`` (float32 2e-5, bfloat16 6e-2).  The plain
versions are themselves held against the JAX package on the CPU
(``tests/test_torch_kernels.py``, ``tests/test_torch_paged_attn.py``,
``tests/test_torch_baselines.py``).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import api, convert
from repro_torch.configs import smoke_config
from repro_torch.core import continuity as ch
from repro_torch.core import hashfn
from repro_torch.core import level as lv
from repro_torch.core import pfarm as pf
from repro_torch.data import ycsb
from repro_torch.kernels import _cuda, mutate, paged_attn, probe, scan_walk
from repro_torch.kernels import ops as K
from repro_torch.kernels.mutate_ref import mutate_ref
from repro_torch.kernels.paged_attn_ref import paged_attention_ref
from repro_torch.kernels.probe_ref import probe_ref
from repro_torch.kernels.scan_walk_ref import scan_walk_ref
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC

pytestmark = pytest.mark.cuda
BIG = 0x7FFFFFFF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def words(a, dev):
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32)).view(np.int32)).to(dev)


def probe_case(seed, P, S, B, fill, dev):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 2 ** 32, size=(P, 4 * S), dtype=np.uint64)
    if fill is None:
        ind = rng.randint(0, 2 ** 32, size=(P, 1), dtype=np.uint64)
        ind[::2] |= np.uint64(1 << 31)
    else:
        ind = np.full((P, 1), fill, np.uint64)
    seg = (S * 4) // 5
    prio = np.full((2, S), BIG, np.int32)
    prio[0, :seg] = np.arange(seg)
    prio[1, list(range(S - 1, S - 1 - seg, -1))] = np.arange(seg)
    pairs = rng.randint(0, P, size=B)
    q = rng.randint(0, 2 ** 32, size=(B, 4), dtype=np.uint64)
    plant = rng.randint(0, S, size=B)
    q[::2] = rows[pairs[::2]].reshape(-1, S, 4)[np.arange(len(plant[::2])),
                                                 plant[::2]]
    fps = rng.randint(0, 2 ** 32, size=(P, 2), dtype=np.uint64)
    return (words(rows, dev), words(ind, dev), torch.from_numpy(prio).to(dev),
            torch.from_numpy(pairs.astype(np.int32)).to(dev),
            torch.from_numpy(rng.randint(0, 2, size=B).astype(np.int32))
            .to(dev), words(q, dev), words(fps, dev),
            torch.from_numpy(rng.randint(0, 4, size=B).astype(np.int32))
            .to(dev))


@pytest.mark.parametrize("S,B,fill", [(20, 1, None), (20, 4099, None),
                                      (10, 33, None), (30, 777, None),
                                      (32, 512, None), (20, 1000, 0),
                                      (20, 1000, 0xFFFFF),
                                      (20, 1000, 0xFFFFFFFF)])
def test_kernels_match_plain_versions(dev, S, B, fill):
    rows, ind, prio, pairs, par, q, fps, qfp = probe_case(S * B, 257, S, B,
                                                          fill, dev)
    n0 = probe.probe_segments.launches, mutate.mutate_segments.launches
    got = probe.probe_segments(rows, ind, prio, pairs, par, q)
    want = probe_ref(rows, ind, prio, pairs, par, q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = probe.probe_segments(rows, ind, prio, pairs, par, q, fps, qfp)
    want = probe_ref(rows, ind, prio, pairs, par, q, fps, qfp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = mutate.mutate_segments(rows, ind, fps, prio, pairs, par, q, qfp)
    want = mutate_ref(rows, ind, fps, prio, pairs, par, q, qfp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert (probe.probe_segments.launches,
            mutate.mutate_segments.launches) == (n0[0] + 2, n0[1] + 1)


def test_wrappers_reject_operands_they_do_not_take(dev):
    rows, ind, prio, pairs, par, q, fps, qfp = probe_case(1, 64, 20, 64,
                                                          None, dev)
    with pytest.raises(ValueError, match="int32"):
        probe.probe_segments(rows, ind, prio, pairs.long(), par, q)
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_segments(rows, ind, prio, pairs, par,
                             q.t().contiguous().t())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 4 + 1, dtype=torch.int32, device=dev)
        probe.probe_segments(rows, ind, prio, pairs, par,
                             flat[1:].view(64, 4))
    with pytest.raises(ValueError, match="expected"):
        probe.probe_segments(rows, ind.cpu(), prio, pairs, par, q)


def tie_case(seed, P, S, B, dev, pairs=None, shuffle=False):
    """``probe_case`` with ranks repeated three slots at a time (ties go
    to the lowest slot) and the last fifth of slots no candidate, keys
    drawn from two words so that rows repeat the query's key in several
    slots, and fp words equal to the planted field, so matches tie too.
    ``shuffle`` permutes each parity's candidate ranks (no probe order
    follows the slots)."""
    rng = np.random.RandomState(seed)
    rows, ind, _, pr, par, q, fps, qfp = probe_case(seed, P, S, B, None, dev)
    rows = (rows & 1).contiguous()
    q = (q & 1).contiguous()
    prio = np.full((2, S), BIG, np.int32)
    live = max(1, S - S // 5)
    prio[0, :live] = np.arange(live) // 3
    prio[1, S - live:] = (np.arange(live) // 3)[::-1]
    if shuffle:
        prio[0, :live] = rng.permutation(prio[0, :live])
        prio[1, S - live:] = rng.permutation(live)
    qfp = torch.from_numpy(rng.randint(0, 2, size=B).astype(np.int32)).to(dev)
    fps = words(np.full((P, 2), 0x55555555, np.uint64) *
                rng.randint(0, 2, size=(P, 1)).astype(np.uint64), dev)
    if pairs is not None:
        pr = torch.from_numpy(np.asarray(pairs, np.int32)).to(dev)
    return (rows, ind, torch.from_numpy(prio).to(dev), pr, par, q, fps, qfp)


def kernel_modes(args, grid=None):
    """The kernel's outputs in its three modes on ``args`` (probe_case
    order): probe, probe with the fp filter, mutate."""
    rows, ind, prio, pairs, par, q, fps, qfp = args
    return [_cuda.launch_segment_probe(mode, rows, ind, fps, prio, pairs, par,
                                       q, qfp, grid=grid)[:n]
            for mode, n in ((_cuda.MODE_PROBE, 2), (_cuda.MODE_PROBE_FP, 2),
                            (_cuda.MODE_MUTATE, 3))]


def plain_modes(args):
    """The plain versions' outputs, in ``kernel_modes``' order."""
    rows, ind, prio, pairs, par, q, fps, qfp = args
    return [probe_ref(rows, ind, prio, pairs, par, q),
            probe_ref(rows, ind, prio, pairs, par, q, fps, qfp),
            mutate_ref(rows, ind, fps, prio, pairs, par, q, qfp)]


def run_modes(args, grid=None):
    """(kernel, plain) outputs of each mode on ``args``."""
    return list(zip(kernel_modes(args, grid), plain_modes(args)))


def full_wave(dev, S):
    """Queries that the tiled kernel holds in flight at once: a tile of 32
    on every warp of one wave."""
    resident = _cuda.probe_resident_blocks(dev.index or 0,
                                           _cuda.MODE_PROBE_FP, S, False)
    return (resident * _cuda.sm_count(dev.index or 0) * _cuda.PROBE_WARPS
            * _cuda.PROBE_TILE)


@pytest.mark.parametrize("S", [1, 16, 20, 30, 32])
@pytest.mark.parametrize("B", ["1", "31", "32", "33", "wave-1", "wave",
                               "wave+1", "65531"])
@pytest.mark.parametrize("tiled", [False, True], ids=["host", "tiled"])
def test_segment_kernels_exact_at_tile_edges(dev, S, B, tiled):
    """All three modes against the plain versions, integer-exact, at batch
    sizes on the edges of a tile and of one full wave of tiles, with tied
    ranks and keys repeated in a row: on the host's grid, and on tiles of
    32 whatever the batch (the host gives a small batch a warp per
    query)."""
    if B.startswith("wave"):
        n = full_wave(dev, S) + int(B[4:] or 0)
    else:
        n = int(B)
    grid = None
    if tiled:
        resident = _cuda.probe_resident_blocks(dev.index or 0,
                                               _cuda.MODE_PROBE_FP, S, False)
        tiles = -(-n // _cuda.PROBE_TILE)
        grid = (min(resident * _cuda.sm_count(dev.index or 0),
                    -(-tiles // _cuda.PROBE_WARPS)), _cuda.PROBE_TILE)
    for got, want in run_modes(tie_case(S * 7 + len(B), 301, S, n, dev),
                               grid):
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S,B,grid", [(20, 4099, (1, 32)), (32, 9000, (1, 32)),
                                      (1, 777, (2, 32)), (20, 65531, (3, 32)),
                                      (20, 4099, (2, 8)), (30, 1000, (1, 1)),
                                      (16, 3000, (5, 16)), (20, 4099, (513, 0)),
                                      (32, 31, (4, 0)), (1, 100, (20, 0))])
def test_segment_kernels_exact_on_small_grids(dev, S, B, grid):
    """A grid of a few blocks walks many tiles per warp, so each warp's
    stage and its mbarrier are reused many times; power-of-two tiles of 1
    to 32 queries, as the host picks them, and the one-warp-per-query
    kernel (tile 0) with spare warps."""
    for got, want in run_modes(tie_case(B + S, 257, S, B, dev), grid):
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [20, 32])
def test_segment_kernels_exact_over_many_tiles_per_warp(dev, S):
    """On the host's grid, a batch of four full waves and a bit: tiles of
    32, each warp walking four or five of them through its one stage and
    mbarrier, as the store's read-back batch does."""
    n = 4 * full_wave(dev, S) + 3
    index = dev.index or 0
    blocks, tile = _cuda.probe_grid(
        n, _cuda.sm_count(index),
        *(_cuda.probe_resident_blocks(index, _cuda.MODE_PROBE_FP, S, d)
          for d in (False, True)))
    assert tile == _cuda.PROBE_TILE
    assert -(-n // tile) > 4 * blocks * _cuda.PROBE_WARPS
    for got, want in run_modes(tie_case(S + 3, 4099, S, n, dev)):
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [1, 16, 20, 32])
@pytest.mark.parametrize("grid", [None, (4, 32)])
def test_segment_kernels_exact_with_unordered_ranks(dev, S, grid):
    """Ranks that follow no slot order: the kernel keeps the running
    minimum of (rank, slot) instead of taking the first slot in order."""
    args = tie_case(S + 5, 199, S, 7777, dev, shuffle=True)
    for got, want in run_modes(args, grid):
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [16, 20, 32])
def test_segment_kernels_pairs_out_of_range(dev, S):
    """Pairs -1, P and far outside the table read nothing and report -1 /
    -1 with flip 0; the other queries of their tiles are unaffected."""
    P, B = 64, 1000
    rng = np.random.RandomState(S)
    pairs = rng.randint(0, P, size=B)
    bad = rng.rand(B) < 0.3
    pairs[bad] = rng.choice([-1, P, 2 ** 31 - 1, -2 ** 31], size=bad.sum())
    pairs[32:64] = -1                       # one whole tile out of range
    args = tie_case(S, P, S, B, dev, pairs=pairs)
    safe = list(args)
    safe[3] = torch.where(args[3].cpu().ge(0) & args[3].cpu().lt(P),
                          args[3].cpu(), 0).to(dev)
    bad = torch.from_numpy(bad | (np.arange(B) // 32 == 1)).to(dev)
    for got, want in zip(kernel_modes(args), plain_modes(safe)):
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g[bad], torch.full_like(g[bad],
                                                       0 if i == 2 else -1))
            assert torch.equal(g[~bad], w[~bad])


def test_segment_kernels_tile_of_one_pair(dev):
    """Every query of a tile on one pair (32 copies of one row in
    flight), and one pair for the whole batch."""
    P, S, B = 97, 20, 32 * 40 + 5
    rng = np.random.RandomState(3)
    for pairs in (np.repeat(rng.randint(0, P, size=41), 32)[:B],
                  np.full(B, 7)):
        args = tie_case(11, P, S, B, dev, pairs=pairs)
        for got, want in run_modes(args):
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_segment_probe_grid_fills_one_wave(dev):
    """The host's grid comes from the occupancy of the instantiation
    launched: at least one block per SM, at most one wave, no more warps
    than tiles."""
    index = dev.index or 0
    sms = _cuda.sm_count(index)
    for mode in (_cuda.MODE_PROBE, _cuda.MODE_PROBE_FP, _cuda.MODE_MUTATE):
        for S in (1, 20, 32):
            resident = _cuda.probe_resident_blocks(index, mode, S, False)
            direct = _cuda.probe_resident_blocks(index, mode, S, True)
            assert resident >= 1 and direct >= 1
            for B in (1, 4224, 65536, 2 ** 20):
                blocks, tile = _cuda.probe_grid(B, sms, resident, direct)
                assert blocks <= (resident if tile else direct) * sms
                assert (blocks - 1) * _cuda.PROBE_WARPS * (tile or 1) < B
    # serving's lookup batch takes a warp per query; the store's batches
    # take tiles
    S = 20
    res = [_cuda.probe_resident_blocks(index, 1, S, d) for d in (False, True)]
    assert _cuda.probe_grid(4224, sms, *res)[1] == 0
    assert _cuda.probe_grid(65536, sms, *res)[1] == 32


@pytest.mark.parametrize("B", [4224, 65536])   # one warp per query; tiles
def test_segment_kernels_make_no_host_sync(dev, B):
    """The probe and mutate wrappers read nothing back from the device."""
    args = probe_case(5, 4096, 20, B, None, dev)
    rows, ind, prio, pairs, par, q, fps, qfp = args
    calls = (lambda: probe.probe_segments(rows, ind, prio, pairs, par, q),
             lambda: probe.probe_segments(*args[:6], fps, qfp),
             lambda: mutate.mutate_segments(rows, ind, fps, prio, pairs, par,
                                            q, qfp))
    for call in calls:                 # build and load outside the check
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):    # the check is live
            pairs.max().item()
        outs = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = probe_ref(rows, ind, prio, pairs, par, q)
    assert all(torch.equal(g, w) for g, w in zip(outs[0], want))


def test_store_on_card_matches_store_on_cpu(dev):
    """The CUDA main path (kernel policy) leaves byte-identical tables and
    results to the CPU path (plain versions), stash tier included."""
    stores = [api.make_store("continuity", table_slots=2048, device=d)
              for d in ("cpu", "cuda")]
    rng = np.random.RandomState(0)
    ids = np.concatenate([np.arange(2400), rng.randint(0, 2400, 64)])
    keys, vals = ycsb.make_key(ids), ycsb.make_value(rng, len(ids))
    vals2 = ycsb.make_value(rng, len(ids))
    q = np.concatenate([keys, ycsb.negative_keys(rng, 2400, 256)])
    out = []
    for st in stores:
        t = st.create()
        t, r1 = st.insert(t, keys, vals)
        t, r2 = st.update(t, keys[::2], vals2[::2])
        t, r3 = st.delete(t, keys[1::3])
        r4 = st.lookup(t, q)
        out.append((t, [r1.ok, r2.ok, r3.ok, r4.ok, r4.values, r4.reads],
                    [r.ledger for r in (r1, r2, r3, r4)]))
    (tc, rc, lc), (tg, rg, lg) = out
    assert int(tc.count) > 0 and int((tc.stash_meta != 0).sum()) > 0
    for a, b in zip(tc, tg):
        assert torch.equal(a, b.cpu())
    for a, b in zip(rc, rg):
        assert torch.equal(a, b.cpu())
    for a, b in zip(lc, lg):
        assert [int(x) for x in a] == [int(x) for x in b]


def test_lookup_policies_agree_on_card(dev):
    cfg = ch.ContinuityConfig(num_buckets=4096)
    store = api.ContinuityStore(cfg=cfg, device="cuda")
    rng = np.random.RandomState(1)
    keys = ycsb.make_key(np.arange(30000))
    t, _ = store.insert(store.create(), keys, ycsb.make_value(rng, 30000))
    q = np.concatenate([keys[::3], ycsb.negative_keys(rng, 30000, 5000)])
    n0 = probe.probe_segments.launches
    a = store.lookup(t, q)
    assert probe.probe_segments.launches == n0 + 1
    b = store.with_policy(api.ExecPolicy(probe="gather")).lookup(t, q)
    for x, y in zip((a.ok, a.values, a.reads, *a.plan),
                    (b.ok, b.values, b.reads, *b.plan)):
        assert torch.equal(x, y)
    for x, y in zip(K.probe_lookup(cfg, t, q), ch.lookup(cfg, t, q)):
        assert torch.equal(x, y)


def attn_case(seed, B, H, KVH, D, PS, MAXP, lens=None, q_scale=0.5):
    """Pages of a shuffled pool mapped for each sequence's live length;
    the rest of the table unmapped (-1).  Scores have std q_scale * 0.3."""
    rng = np.random.RandomState(seed)
    NP = B * MAXP + 2
    q = (rng.randn(B, H, D) * q_scale).astype(np.float32)
    kp = (rng.randn(NP, KVH, PS, D) * 0.3).astype(np.float32)
    vp = rng.randn(NP, KVH, PS, D).astype(np.float32)
    if lens is None:
        lens = rng.randint(1, MAXP * PS, size=(B,))
    lens = np.asarray(lens, np.int32)
    pt = np.full((B, MAXP), -1, np.int32)
    perm = rng.permutation(NP)
    c = 0
    for b in range(B):
        for p in range(int(np.ceil(lens[b] / PS))):
            pt[b, p] = perm[c]
            c += 1
    return [torch.from_numpy(a) for a in (q, kp, vp, pt, lens)]


def on(args, dev, dtype):
    q, kp, vp, pt, lens = args
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            pt.to(dev), lens.to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("B,H,KVH,D,PS,MAXP", [
    (2, 4, 1, 16, 8, 3), (3, 8, 2, 32, 16, 4), (1, 16, 4, 64, 32, 2),
    (4, 4, 4, 16, 8, 5),                    # G = 1
    (5, 32, 4, 128, 16, 9),                 # Yi-6B's heads, G = 8
    (2, 24, 2, 256, 64, 3),                 # G = 12 (two blocks), D = 256
    (3, 8, 8, 40, 512, 2),                  # D not a multiple of 32
])
def test_paged_attention_matches_plain(dev, dtype, tol, B, H, KVH, D, PS,
                                       MAXP):
    args = on(attn_case(B * 100 + H, B, H, KVH, D, PS, MAXP), dev, dtype)
    n0 = paged_attn.paged_attention.launches
    got = paged_attn.paged_attention(*args)
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged_attn.paged_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (B, H, D)
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
def test_paged_attention_page_boundaries(dev, dtype, tol):
    PS, MAXP = 16, 4
    args = on(attn_case(3, 7, 16, 2, 64, PS, MAXP,
                        lens=[PS, PS + 1, 2 * PS, 2 * PS + 1, 1, 3 * PS,
                              MAXP * PS]), dev, dtype)
    got = paged_attn.paged_attention(*args)
    want = paged_attention_ref(*args)
    assert float((got.float() - want.float()).abs().max()) < tol


def test_paged_attention_ignores_dead_pages(dev):
    rng = np.random.RandomState(7)
    B, H, KVH, D, PS, MAXP, NP = 2, 16, 2, 32, 8, 4, 16
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
                 for s in ((B, H, D), (NP, KVH, PS, D), (NP, KVH, PS, D)))
    pt = torch.full((B, MAXP), -1, dtype=torch.int32, device=dev)
    pt[:, 0] = torch.tensor([0, 1], dtype=torch.int32)
    pt[0, 2] = 5                        # mapped, but past the length
    lens = torch.tensor([5, 3], dtype=torch.int32, device=dev)
    base = paged_attn.paged_attention(q, kp, vp, pt, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[2:] = 1e3
    vp2[2:] = -1e3                      # poison every page not read
    out = paged_attn.paged_attention(q, kp2, vp2, pt, lens)
    torch.testing.assert_close(out, base, rtol=1e-6, atol=0)
    torch.testing.assert_close(base, paged_attention_ref(q, kp, vp, pt, lens),
                               rtol=0, atol=2e-5)


def test_paged_attention_rejects_operands_it_does_not_take(dev):
    q, kp, vp, pt, lens = on(attn_case(1, 2, 8, 2, 32, 8, 3), dev,
                             torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged_attn.paged_attention(q.half(), kp.half(), vp.half(), pt, lens)
    with pytest.raises(ValueError, match="vpool must be"):
        paged_attn.paged_attention(q, kp, vp.bfloat16(), pt, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_attn.paged_attention(q, kp, vp, pt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attn.paged_attention(q, kp.transpose(2, 3).contiguous()
                                   .transpose(2, 3), vp, pt, lens)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attn.paged_attention(q[..., :12].contiguous(),
                                   kp[..., :12].contiguous(),
                                   vp[..., :12].contiguous(), pt, lens)
    with pytest.raises(ValueError, match="expected"):
        paged_attn.paged_attention(q, kp, vp, pt.cpu(), lens)


def split_case(dev, dtype, splits, G=8, D=128, PS=16, MAXP=9, seed=0):
    """Lengths 0, 1, full, and one before and one past the first two split
    boundaries of ``splits`` (page boundaries of the split kernel); the
    full-length sequence has an unmapped page at the first boundary."""
    edges = [e * PS for _, e in _cuda.split_pages(MAXP, splits)
             if 0 < e < MAXP] or [PS]
    lens = [0, 1, MAXP * PS] + [x for e in edges[:2] for x in (e - 1, e + 1)]
    q, kp, vp, pt, ln = attn_case(seed, len(lens), 2 * G, 2, D, PS, MAXP,
                                  lens=lens)
    pt[2, edges[0] // PS] = -1
    return on((q, kp, vp, pt, ln), dev, dtype)


def check_split_call(args, tol, splits):
    """The kernel at ``splits`` against the plain version: zeros where the
    length is 0 (the plain version's softmax over nothing is NaN), within
    ``tol`` elsewhere, and bit-identical on a second call."""
    q = args[0]
    scale = float(1.0 / q.shape[-1] ** 0.5)
    got = _cuda.launch_paged_attn(*args, scale, splits=splits)
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    live = args[4] > 0
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert float((got[live].float() - want[live].float()).abs().max()) < tol
    assert torch.equal(_cuda.launch_paged_attn(*args, scale, splits=splits),
                       got)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("splits", [0, 1, 2, 3, 20])   # 20 > 9 pages
def test_paged_attention_split_counts(dev, dtype, tol, splits):
    check_split_call(split_case(dev, dtype, splits or 3), tol, splits)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("G,D,PS,MAXP", [
    (1, 40, 512, 3), (8, 40, 512, 3), (12, 40, 512, 3),
    (1, 256, 512, 3), (8, 256, 512, 3), (12, 256, 512, 3),
    (20, 64, 16, 7),                        # two 16-head groups in bf16
])
@pytest.mark.parametrize("splits", [0, 2])
def test_paged_attention_split_shapes(dev, dtype, tol, G, D, PS, MAXP,
                                      splits):
    check_split_call(split_case(dev, dtype, splits or 2, G, D, PS, MAXP,
                                seed=G * D), tol, splits)


def test_paged_attention_serving_shape_bf16(dev):
    """Yi-6B's last decode step (B 32, H 32, KVH 4, D 128, PS 16, 2,111
    tokens) in bf16: within 6e-2 and 2 % of the largest plain output, a
    limit that an output one token or one page short breaks."""
    PS, MAXP, n = 16, 132, 2111
    q, kp, vp, pt, lens = on(attn_case(5, 32, 32, 4, 128, PS, MAXP,
                                       lens=[n] * 32, q_scale=4.0), dev,
                             torch.bfloat16)
    got = K.paged_attention(q, kp, vp, pt, lens).float()
    want = paged_attention_ref(q, kp, vp, pt, lens).float()
    limit = min(6e-2, 2e-2 * float(want.abs().max()))
    assert float((got - want).abs().max()) <= limit
    for cut in (1, PS):
        short = paged_attention_ref(q, kp, vp, pt, lens - cut).float()
        assert float((short - want).abs().max()) > limit


@pytest.mark.parametrize("splits", [1, 3])
def test_paged_attention_poison_bf16_bit_identical(dev, splits):
    """Poison in every page not read (unmapped, or mapped past the length)
    leaves the bf16 output bit-identical."""
    q, kp, vp, pt, lens = split_case(dev, torch.bfloat16, 3, seed=9)
    free = sorted(set(range(kp.shape[0])) - set(pt.flatten().tolist()))
    pt[3, -1] = free[0]               # mapped, but past that length
    scale = float(1.0 / q.shape[-1] ** 0.5)
    base = _cuda.launch_paged_attn(q, kp, vp, pt, lens, scale, splits=splits)
    read = torch.zeros(kp.shape[0], dtype=torch.bool, device=dev)
    for b in range(pt.shape[0]):
        n = -(-int(lens[b]) // kp.shape[2])
        ids = pt[b, :n]
        read[ids[ids >= 0].long()] = True
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[~read], vp2[~read] = 1e3, -1e3
    out = _cuda.launch_paged_attn(q, kp2, vp2, pt, lens, scale,
                                  splits=splits)
    assert torch.equal(out, base)


def test_paged_attention_split_count_fills_one_wave(dev):
    """The host's split count comes from the occupancy of the instantiation
    launched: two bf16 blocks of D 128 fit an SM's shared memory, one of
    D 256; the blocks of one call fill at most one wave."""
    bf16, f32 = (_cuda.PAGED_ATTN_DTYPES[t]
                 for t in (torch.bfloat16, torch.float32))
    index = torch.cuda.current_device()
    assert _cuda.resident_blocks(index, bf16, 128) == 2
    assert _cuda.resident_blocks(index, bf16, 256) == 1
    assert _cuda.resident_blocks(index, bf16, 40) >= 2
    assert _cuda.resident_blocks(index, f32, 128) >= 1
    sms = _cuda.sm_count(index)
    for dtype, D in ((bf16, 128), (bf16, 256), (f32, 128)):
        resident = _cuda.resident_blocks(index, dtype, D)
        for seq_heads in (16, 128):
            splits = _cuda.paged_attn_splits(seq_heads, 132, sms, resident)
            assert seq_heads * splits <= max(seq_heads, resident * sms)


def test_paged_attention_makes_no_host_sync(dev):
    """One decode layer's call reads nothing back from the device, in each
    route: bf16, int8 under bf16 q (tensor cores), float32 and int8 under
    float32 q (the CUDA-core loop)."""
    base = attn_case(4, 32, 32, 4, 128, 16, 132, lens=[2111] * 32)
    args = on(base, dev, torch.bfloat16)
    q, kp, vp, pt, lens = on(base, dev, torch.float32)
    (kq, ks), (vq, vs) = KC.quant_store(kp), KC.quant_store(vp)
    calls = [lambda: K.paged_attention(*args),
             lambda: K.paged_attention(q.bfloat16(), kq, vq, pt, lens,
                                       kscale=ks, vscale=vs),
             lambda: K.paged_attention(q, kp, vp, pt, lens),
             lambda: K.paged_attention(q, kq, vq, pt, lens, kscale=ks,
                                       vscale=vs)]
    for call in calls:                # build and load outside the check
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):    # the check is live
            args[4].max().item()
        outs = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for out in outs:
        assert bool(out.float().isfinite().all())


ROUTES = {0: (torch.float32, False), 1: (torch.bfloat16, False),
          2: (torch.float32, True), 3: (torch.bfloat16, True)}


def slice_case(dev, route, G, D, PS, m, seed=0):
    """A slice-mode case of ``route`` (q's dtype, int8 pools or not):
    lengths leaving whole slices of the last page with no live token, or
    every slice but the first empty (length 1)."""
    dtype, quant = ROUTES[route]
    MAXP = 4
    lens = [1, PS // m, PS + 1, 2 * PS - 1, 3 * PS + PS // 2, MAXP * PS]
    q, kp, vp, pt, ln = on(attn_case(seed, len(lens), 2 * G, 2, D, PS, MAXP,
                                     lens=lens), dev, torch.float32)
    kw = {}
    if quant:
        (kp, ks), (vp, vs) = KC.quant_store(kp), KC.quant_store(vp)
        kw = {"kscale": ks, "vscale": vs}
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q.to(dtype), kp, vp, pt, ln), kw


def slice_of(t, m, r):
    n = t.shape[2] // m
    return t[:, :, r * n:(r + 1) * n].contiguous()


def run_slices(args, kw, m, fn=paged_attn.paged_attention,
               merge=paged_attn.merge_partials):
    """Every slice's partials through ``fn``, merged by ``merge``."""
    q, kp, vp, pt, lens = args
    PS = kp.shape[2]
    parts = [fn(q, slice_of(kp, m, r), slice_of(vp, m, r), pt, lens,
                page_stride=PS, token_offset=r * (PS // m),
                **{k: slice_of(v, m, r) for k, v in kw.items()})
             for r in range(m)]
    return merge(torch.cat([a for a, _ in parts], 2),
                 torch.cat([b for _, b in parts], 2), q.dtype)


def plain_slices(q, kp, vp, pt, lens, **kw):
    return paged_attention_ref(q, kp, vp, pt, lens, partials=True, **kw)


@pytest.mark.parametrize("route", [0, 1, 2, 3])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("PS", [16, 32])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_slice_mode_matches_plain(dev, route, G, D, PS, m):
    """m slices of each page through the kernel's slice mode and the merge
    kernel, against the unsliced plain version and the plain slice mode's
    merge (float32 q 2e-5, bf16 q 6e-2); with one slice, bit-equal to the
    whole-page launch."""
    args, kw = slice_case(dev, route, G, D, PS, m, seed=route * 97 + G * D)
    q = args[0]
    tol = 2e-5 if q.dtype == torch.float32 else 6e-2
    n0 = (paged_attn.paged_attention.slice_launches,
          paged_attn.merge_partials.launches)
    got = run_slices(args, kw, m)
    torch.cuda.synchronize()
    assert (paged_attn.paged_attention.slice_launches,
            paged_attn.merge_partials.launches) == (n0[0] + m, n0[1] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = paged_attention_ref(*args, **kw)
    assert float((got.float() - want.float()).abs().max()) < tol
    plain = run_slices(args, kw, m, fn=plain_slices,
                       merge=lambda a, b, dt: paged_attn.merge_partials_ref(
                           a, b, dt))
    assert float((got.float() - plain.float()).abs().max()) < tol
    if m == 1:
        assert torch.equal(got, paged_attn.paged_attention(*args, **kw))


def poisoned(args, kw):
    """The case with every pool row that holds no live token (past a
    length, or of an unmapped page) poisoned, and NaN in its int8 scales."""
    q, kp, vp, pt, lens = args
    PS, NP = kp.shape[2], kp.shape[0]
    live = torch.zeros(NP, PS, dtype=torch.bool, device=kp.device)
    for b in range(pt.shape[0]):
        for p in range(pt.shape[1]):
            if int(pt[b, p]) >= 0:
                n = min(max(int(lens[b]) - p * PS, 0), PS)
                live[int(pt[b, p]), :n] = True
    dead = ~live[:, None, :, None].expand(kp.shape)
    kp2, vp2 = kp.clone(), vp.clone()
    bad = 100 if kp.dtype == torch.int8 else 1e3
    kp2[dead], vp2[dead] = bad, -bad
    kw2 = {k: torch.where(dead[..., :1], float("nan"), v)
           for k, v in kw.items()}
    return (q, kp2, vp2, pt, lens), kw2


@pytest.mark.parametrize("route", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [2, 4])
def test_slice_mode_ignores_poisoned_rows(dev, route, m):
    """Poison in every slice row that holds no live token (past a length,
    or of an unmapped page) leaves the merged output bit-identical."""
    args, kw = slice_case(dev, route, 8, 128, 16, m, seed=5)
    base = run_slices(args, kw, m)
    assert torch.equal(run_slices(*poisoned(args, kw), m), base)


def int8_slice_case(dev, G, D, PS, seed):
    """``route_case``'s sequences (lengths 0, 1, two pages, past a dead
    page) in bf16 q over int8 pools, with the plain version's dequantized
    bf16 pools: ((q, kq, vq, pt, lens), {kscale, vscale}, (kb, vb))."""
    (q, _, _, pt, ln), (kq, ks, vq, vs) = route_case(seed, G, D, PS, dev)
    deq = (KC.dequant(kq, ks, torch.bfloat16),
           KC.dequant(vq, vs, torch.bfloat16))
    return (q.bfloat16(), kq, vq, pt, ln), {"kscale": ks, "vscale": vs}, deq


def int8_slices_equal_bf16(args, kw, deq, m, splits):
    """Every slice's partials of the int8 route against the bf16 route's on
    the dequantized pools at ``splits`` (0: the int8 route's host count,
    the bf16 route launched at the same count), bit for bit; returns the
    int8 route's merged output."""
    q, kq, vq, pt, lens = args
    PS = kq.shape[2]
    scale = float(1.0 / q.shape[2] ** 0.5)
    parts = []
    for r in range(m):
        cut = {k: slice_of(v, m, r) for k, v in kw.items()}
        got = _cuda.launch_paged_attn_slice(
            q, slice_of(kq, m, r), slice_of(vq, m, r), pt, lens, scale, PS,
            r * (PS // m), splits=splits, **cut)
        sp = got[0].shape[2]
        assert sp == splits or not splits
        want = _cuda.launch_paged_attn_slice(
            q, slice_of(deq[0], m, r), slice_of(deq[1], m, r), pt, lens,
            scale, PS, r * (PS // m), splits=sp)
        torch.cuda.synchronize()
        live = got[1][..., 0] != float("-inf")    # an empty split's acc is
        assert torch.equal(got[1], want[1])       # never written or read
        assert torch.equal(got[0][live], want[0][live])
        parts.append(got)
    return paged_attn.merge_partials(torch.cat([a for a, _ in parts], 2),
                                     torch.cat([b for _, b in parts], 2),
                                     q.dtype)


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("PS", [16, 32])
@pytest.mark.parametrize("m", [2, 4])
def test_int8_slices_equal_bf16_slices_on_dequantized_pools(dev, G, D, PS,
                                                            m):
    """The int8 slice route stages a tile of whole slice pages as runs (PS /
    m rows of 4 or 8, or 16 and more): at split count 3 and at the host's,
    every slice's partials equal the bf16 slice route's on the dequantized
    pools bit for bit, and the merge is within 6e-2 of the plain
    version."""
    args, kw, deq = int8_slice_case(dev, G, D, PS, seed=G * D + PS + m)
    for splits in (3, 0):
        out = int8_slices_equal_bf16(args, kw, deq, m, splits)
    assert not out[0].any()                     # a length of 0: zeros
    want = paged_attention_ref(*args, **kw)     # (its softmax: NaN)
    assert float((out[1:].float() - want[1:].float()).abs().max()) < 6e-2


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("PS", [16, 32])
def test_int8_slices_of_two_or_four_rows(dev, D, PS):
    """Eight slices of each page: 2 rows per page (16-token pages) keep a
    copy per row (scale runs of 8 bytes), 4 rows (32-token pages) go as
    runs; both equal the bf16 slice route on the dequantized pools bit for
    bit, and the merge is within 6e-2 of the plain version and of the
    plain slice mode's merge."""
    args, kw, deq = int8_slice_case(dev, 8, D, PS, seed=D + PS)
    for splits in (3, 0):
        out = int8_slices_equal_bf16(args, kw, deq, 8, splits)
    assert not out[0].any()                     # a length of 0: zeros
    want = paged_attention_ref(*args, **kw)     # (its softmax: NaN)
    assert float((out[1:].float() - want[1:].float()).abs().max()) < 6e-2
    plain = run_slices(args, kw, 8, fn=plain_slices,
                       merge=lambda a, b, dt: paged_attn.merge_partials_ref(
                           a, b, dt))
    assert float((out.float() - plain.float()).abs().max()) < 6e-2


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("PS", [16, 32])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_int8_slice_runs_ignore_poisoned_rows(dev, D, PS, m):
    """Tiles staged as runs next to tiles staged row by row (a length
    inside a page, a dead page inside a length): poisoned dead rows and
    NaN scales leave every slice's merged output bit-identical."""
    args, kw, _ = int8_slice_case(dev, 8, D, PS, seed=7 * D + PS + m)
    base = run_slices(args, kw, m)
    assert torch.equal(run_slices(*poisoned(args, kw), m), base)


def test_slice_mode_makes_no_host_sync(dev):
    """Two slices of Yi-6B's decode shape and their merge read nothing back
    from the device, in every route."""
    base = attn_case(4, 32, 32, 4, 128, 16, 132, lens=[2111] * 32)
    q, kp, vp, pt, lens = on(base, dev, torch.float32)
    (kq, ks), (vq, vs) = KC.quant_store(kp), KC.quant_store(vp)
    cases = [((q.bfloat16(), kp.bfloat16(), vp.bfloat16(), pt, lens), {}),
             ((q.bfloat16(), kq, vq, pt, lens), {"kscale": ks, "vscale": vs}),
             ((q, kp, vp, pt, lens), {}),
             ((q, kq, vq, pt, lens), {"kscale": ks, "vscale": vs})]
    sliced = [(tuple(a[:1]) + tuple(slice_of(t, 2, r) for t in a[1:3])
               + tuple(a[3:]), {k: slice_of(v, 2, r) for k, v in kw.items()},
               r) for a, kw in cases for r in range(2)]

    def calls():
        parts = [paged_attn.paged_attention(*a, page_stride=16,
                                            token_offset=8 * r, **kw)
                 for a, kw, r in sliced]
        return [paged_attn.merge_partials(
            torch.cat([parts[i][0], parts[i + 1][0]], 2),
            torch.cat([parts[i][1], parts[i + 1][1]], 2), sliced[i][0][0].dtype)
            for i in range(0, len(parts), 2)]
    calls()                           # build and load outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):    # the check is live
            lens.max().item()
        outs = calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for out in outs:
        assert bool(out.float().isfinite().all())


def test_slice_mode_rejects_slices_that_do_not_fit(dev):
    args, kw = slice_case(dev, 1, 8, 64, 16, 2)
    q, kp, vp, pt, lens = args
    with pytest.raises(ValueError, match="does not fit pages"):
        paged_attn.paged_attention(q, slice_of(kp, 2, 1), slice_of(vp, 2, 1),
                                   pt, lens, page_stride=16, token_offset=9)
    with pytest.raises(ValueError, match="does not fit pages"):
        paged_attn.paged_attention(q, kp, vp, pt, lens, page_stride=8)
    acc, ml = paged_attn.paged_attention(q, kp, vp, pt, lens, page_stride=16)
    with pytest.raises(ValueError, match="partials per row"):
        _cuda.launch_paged_attn_merge(acc[:, :, :0], ml[:, :, :0], q.dtype)


def test_serve_steps_on_card_match_cpu(dev):
    """Prefill and decode on the card (probe, paged-attention and mutate
    kernels) against the same on the CPU (plain versions): logits within
    1e-4, page tables and small fields byte-equal, pools within 1e-5."""
    cfg = smoke_config("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="decode")
    rng = np.random.RandomState(2)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 32)).astype(
        np.int32))
    fed = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 6)).astype(np.int32))
    runs = []
    for d in ("cpu", "cuda"):
        p = {k: v.to(d) for k, v in params.items() if k != "blocks"}
        p["blocks"] = {k: v.to(d) for k, v in params["blocks"].items()}
        geom = KC.make_geometry(cfg, shape, shards=2, page_size=16, device=d)
        lg, cache = E.prefill(cfg, geom, p, prompt.to(d),
                              KC.create_cache(geom))
        logits = [lg]
        for i in range(fed.shape[1]):
            lg, cache = E.serve_step(cfg, geom, p, fed[:, i].to(d), cache)
            logits.append(lg)
        cache = E.release_sequence(geom, cache, 1, 0)
        runs.append((logits, convert.cache_to_numpy(cache)))
    (lc, sc), (lg_, sg) = runs
    for a, b in zip(lc, lg_):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for f in sc["table"]:
        assert np.array_equal(sc["table"][f], sg["table"][f]), f
    for f in ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off"):
        assert np.array_equal(sc[f], sg[f]), f
    for f in ("kpool", "vpool"):
        np.testing.assert_allclose(sg[f], sc[f], atol=1e-5, rtol=0)


# -- the serial walk (level and P-FaRM-KV write paths) -----------------------

WALK_CFG = {"level": lv.LevelConfig(num_top=1024),
            "pfarm": pf.PFarmConfig(num_buckets=1024)}
WALK_LOAD = {"level": 5500, "pfarm": 4600}
FROM_NP = {"level": convert.level_table_from_numpy,
           "pfarm": convert.pfarm_table_from_numpy}
TO_NP = {"level": convert.level_table_to_numpy,
         "pfarm": convert.pfarm_table_to_numpy}


@functools.lru_cache(maxsize=None)
def walk_prestate(scheme):
    """A table at high load (level ~0.9, pfarm ~0.9 with chains), built on
    the CPU by the plain version, as numpy fields."""
    cfg = WALK_CFG[scheme]
    mod = lv if scheme == "level" else pf
    t = mod.create(cfg, "cpu")
    n = WALK_LOAD[scheme]
    keys = torch.from_numpy(ycsb.make_key(np.arange(n)).view(np.int32))
    vals = torch.from_numpy(ycsb.make_value(np.random.RandomState(0), n)
                            .view(np.int32))
    scan_walk_ref(scheme, "insert", cfg, t, keys, vals,
                  torch.ones(n, dtype=torch.bool))
    return TO_NP[scheme](t)


def walk_both(scheme, op, cfg, pre, ids, vseed=1, active=None):
    """The batch through the kernel (card) and its plain version (CPU)
    from the same pre-state; asserts every field, ok and pm equal and the
    launch counted; returns the CPU table and (ok, pm)."""
    keys = ycsb.make_key(np.asarray(ids)).view(np.int32)
    vals = ycsb.make_value(np.random.RandomState(vseed), len(ids)).view(
        np.int32)
    if active is None:
        active = np.ones(len(ids), bool)
    outs = []
    for d in ("cpu", "cuda"):
        t = FROM_NP[scheme](pre, d)
        k = torch.from_numpy(keys).to(d)
        v = None if op == "delete" else torch.from_numpy(vals).to(d)
        a = torch.from_numpy(active).to(d)
        n0 = scan_walk.scan_walk.launches
        ok, pm = scan_walk.scan_walk(scheme, op, cfg, t, k, v, a)
        assert scan_walk.scan_walk.launches == n0 + (d == "cuda")
        outs.append((t, ok, pm))
    torch.cuda.synchronize()
    (tc, okc, pmc), (tg, okg, pmg) = outs
    got, want = TO_NP[scheme](tg), TO_NP[scheme](tc)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert torch.equal(okg.cpu(), okc) and torch.equal(pmg.cpu(), pmc)
    return tc, okc, pmc


@pytest.mark.parametrize("variant", ["plain", "masked_dups"])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 4096])
@pytest.mark.parametrize("op", ["insert", "update", "delete"])
@pytest.mark.parametrize("scheme", ["level", "pfarm"])
def test_scan_walk_matches_plain(dev, scheme, op, B, variant):
    cfg, pre = WALK_CFG[scheme], walk_prestate(scheme)
    rng = np.random.RandomState(B)
    n = WALK_LOAD[scheme]
    if op == "insert":
        ids = np.arange(n, n + B)
    else:           # present keys, a few absent
        ids = np.where(rng.rand(B) < 0.85, rng.randint(0, n, B),
                       rng.randint(n, 2 * n, B))
    active = None
    if variant == "masked_dups":
        ids[rng.rand(B) < 0.2] = ids[0]
        active = rng.rand(B) < 0.75
    _, ok, pm = walk_both(scheme, op, cfg, pre, ids, active=active)
    if B == 4096:
        assert 0 < int(ok.sum()) < B


def test_scan_walk_level_move_and_logged_paths(dev):
    """The crafted num_top-4 state of tests/test_torch_baselines.py in one
    batch: 12 plain inserts, then a one-movement insert (5 PM writes);
    then a logged update (4) and an out-of-place one (2)."""
    cfg = lv.LevelConfig(num_top=4)
    ids = np.arange(20_000)
    cand = lv._cand_buckets(cfg, torch.from_numpy(
        ycsb.make_key(ids).view(np.int32))).numpy()
    inner = ids[(cand[:, 0] < 2) & (cand[:, 1] < 2)]
    first = ids[(cand[:, 0] == 0) & (cand[:, 1] == 2)][:1]
    last = inner[11:][cand[inner[11:], 0] == 0][:1]
    order = np.concatenate([first, inner[:11], last])
    empty = convert.level_table_to_numpy(lv.create(cfg, "cpu"))
    t, ok, pm = walk_both("level", "insert", cfg, empty, order)
    assert pm.tolist() == [2] * 12 + [5]
    t, ok, pm = walk_both("level", "update", cfg,
                          convert.level_table_to_numpy(t),
                          np.concatenate([order[[12]], first]))
    assert pm.tolist() == [4, 2]


def _ids_with_home(cfg, want, n):
    ids = np.arange(200_000)
    home = pf._home(cfg, torch.from_numpy(ycsb.make_key(ids).view(np.int32)))
    return ids[home.numpy() == want][:n]


def test_scan_walk_pfarm_displace_chain_and_full_pool(dev):
    """A full window whose last bucket holds items of a later home: the
    25th insert displaces one into bucket 6; later ones chain blocks until
    the 4-block pool is full and inserts fail."""
    cfg = pf.PFarmConfig(num_buckets=16)
    ids = np.concatenate([_ids_with_home(cfg, 5, 4),
                          _ids_with_home(cfg, 0, 20 + 1 + 40)])
    empty = convert.pfarm_table_to_numpy(pf.create(cfg, "cpu"))
    t, ok, pm = walk_both("pfarm", "insert", cfg, empty, ids)
    assert int(t.ocount) == cfg.pool_blocks and int(t.head[0]) >= 0
    assert not bool(ok.all()) and set(pm.tolist()) == {0, 5}
    t1, _, _ = walk_both("pfarm", "insert", cfg, empty, ids[:25])
    np.testing.assert_array_equal(t1.keys[6, 0].numpy(),
                                  ycsb.make_key(ids[:1]).view(np.int32)[0])
    for op in ("update", "delete"):    # hits in the window and the chain
        _, ok, _ = walk_both("pfarm", op, cfg, convert.pfarm_table_to_numpy(t),
                             ids[::-1])
        assert bool(ok.any())


def test_scan_walk_device_hash_equals_hashfn(dev):
    rng = np.random.RandomState(7)
    keys = torch.from_numpy(rng.randint(0, 2 ** 32, size=(1 << 20, 4),
                                        dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))
    h1, h2 = _cuda.launch_scan_walk_hash(keys.to(dev))
    torch.cuda.synchronize()
    want1, want2 = hashfn.hash128(keys), hashfn.hash128_2(keys)
    assert torch.equal(h1.cpu().to(torch.int64) & 0xFFFFFFFF, want1)
    assert torch.equal(h2.cpu().to(torch.int64) & 0xFFFFFFFF, want2)


@pytest.mark.parametrize("steps", [0, 1, 4096])
@pytest.mark.parametrize("elem", [1, 16])
def test_scan_walk_latency_chase_matches_plain(dev, elem, steps):
    rng = np.random.RandomState(steps + elem)
    data = torch.from_numpy(rng.randint(0, 256, (1 << 20) + 3)
                            .astype(np.uint8))
    got = scan_walk.chase(data.to(dev), elem, steps, 0x9E3779B9)
    assert torch.equal(got.cpu(), scan_walk.chase(data, elem, steps,
                                                  0x9E3779B9))


def test_scan_walk_rejects_what_it_does_not_take(dev):
    cfg = pf.PFarmConfig(num_buckets=64, window=9)          # 36 lanes
    t = pf.create(cfg, dev)
    k = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    a = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="warp"):
        scan_walk.scan_walk("pfarm", "insert", cfg, t, k, k, a)
    cfg = pf.PFarmConfig(num_buckets=64)
    t = pf.create(cfg, dev)
    with pytest.raises(ValueError, match="vals"):
        scan_walk.scan_walk("pfarm", "delete", cfg, t, k, k, a)
    n0 = scan_walk.scan_walk.launches
    ok, pm = scan_walk.scan_walk("pfarm", "insert", cfg, t, k[:0], k[:0],
                                 a[:0])
    assert ok.shape == (0,) and scan_walk.scan_walk.launches == n0


def test_baseline_stores_on_card_match_cpu(dev):
    """Each scheme's store on the card (serial-walk kernel for level and
    pfarm) leaves the same tables, results and ledgers as on the CPU."""
    rng = np.random.RandomState(3)
    ids = np.concatenate([np.arange(900), rng.randint(0, 900, 40)])
    keys, vals = ycsb.make_key(ids), ycsb.make_value(rng, len(ids))
    q = np.concatenate([keys, ycsb.negative_keys(rng, 900, 100)])
    for scheme, to_np in (("level", convert.level_table_to_numpy),
                          ("pfarm", convert.pfarm_table_to_numpy),
                          ("dense", convert.dense_table_to_numpy)):
        out = []
        for d in ("cpu", "cuda"):
            st = api.make_store(scheme, table_slots=1000, device=d)
            t, r1 = st.insert(st.create(), keys, vals)
            t, r2 = st.update(t, keys[::2], vals[::-2])
            t, r3 = st.delete(t, keys[1::3])
            r4 = st.lookup(t, q)
            out.append((to_np(t), [r1.ok, r2.ok, r3.ok, r4.ok, r4.values,
                                   r4.reads, *r4.plan],
                        [[int(x) for x in r.ledger]
                         for r in (r1, r2, r3, r4)]))
        (tc, rc, lc), (tg, rg, lg) = out
        for f in tc:
            np.testing.assert_array_equal(tg[f], tc[f], err_msg=f)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(rc, rg))
        assert lc == lg


# -- maintenance and crash consistency ---------------------------------------

TO_NUMPY = {"continuity": convert.table_to_numpy,
            "level": convert.level_table_to_numpy,
            "pfarm": convert.pfarm_table_to_numpy,
            "dense": convert.dense_table_to_numpy}


def _assert_fields_equal(a, b):
    assert a.keys() == b.keys()
    for f in a:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)


@pytest.mark.parametrize("op", ["insert", "update", "delete"])
@pytest.mark.parametrize("stash", [0.0, 1 / 8], ids=["nostash", "stash"])
def test_serial_oracles_on_card_match_cpu(dev, op, stash):
    """The serial oracles on the card leave the CPU's tables, ok flags and
    ledgers, and the card's wave engine lands on the same bytes, on a
    table loaded into its extension pool and (stash) its stash."""
    cfg = ch.ContinuityConfig(num_buckets=32, ext_frac=1.0, stash_frac=stash)
    rng = np.random.RandomState(4)
    n_base = 192 if op == "insert" else 448
    kb, vb = ycsb.make_key(np.arange(n_base)), ycsb.make_value(rng, n_base)
    start = n_base - 64 if op == "insert" else 0
    ids = np.arange(start, start + 512)
    ids[-64:] = start + rng.randint(0, 256, 64)          # duplicates
    K, V = ycsb.make_key(ids), ycsb.make_value(rng, 512)
    mask = rng.rand(512) > 0.1
    out = []
    for d, serial in (("cpu", True), ("cuda", True), ("cuda", False)):
        t = ch.create(cfg, d)
        ch.insert(cfg, t, kb, vb)
        fn = getattr(ch, f"{op}_serial" if serial else op)
        args = (K,) if op == "delete" else (K, V)
        _, ok, led = fn(cfg, t, *args, mask)
        out.append((convert.table_to_numpy(t), ok.cpu(),
                    [int(x) for x in led]))
    (tc, okc, lc), *rest = out
    assert int(okc.sum()) > 0
    for tg, okg, lg in rest:
        _assert_fields_equal(tc, tg)
        assert torch.equal(okc, okg) and lc == lg


def test_resize_and_split_on_card_match_cpu(dev):
    """``resize`` and the online split (interleaved with routed writes and
    dual reads) give the CPU's tables, tokens and results on the card."""
    rng = np.random.RandomState(6)
    K, V = ycsb.make_key(np.arange(700)), ycsb.make_value(rng, 700)
    W = ycsb.make_key(np.arange(1000, 1040))
    out = []
    for d in ("cpu", "cuda"):
        store = api.make_store("continuity", table_slots=800, device=d)
        t, _ = store.insert(store.create(), K, V)
        _, grown = ch.resize(store.cfg, t, chunk=100)
        rs = store.begin_resize(t, step_slo_us=25.0)
        res = [rs.step_budget]
        while not rs.done:
            i = len(res) % 40
            rs, r = store.resize_write(rs, "insert", W[i:i + 1], V[i:i + 1])
            rs, r2 = store.resize_write(rs, "delete", K[i * 7:i * 7 + 3])
            rs = store.resize_step(rs)
            lk = store.resize_lookup(rs, K[::5])
            res += [r.ok.cpu(), r2.ok.cpu(), lk.ok.cpu(), lk.values.cpu()]
        new_store, new_t = store.resize_cutover(rs)
        out.append((convert.table_to_numpy(grown), convert.table_to_numpy(t),
                    convert.table_to_numpy(new_t), rs.moved, res))
    (gc, tc, nc, mc, rc), (gg, tg, ng, mg, rg) = out
    for a, b in ((gc, gg), (tc, tg), (nc, ng)):
        _assert_fields_equal(a, b)
    assert mc == mg and rc[0] == rg[0]
    assert all(torch.equal(a, b) for a, b in zip(rc[1:], rg[1:]))


@pytest.mark.parametrize("scheme", ["continuity", "level", "pfarm", "dense"])
def test_crash_matrix_and_resize_on_card_match_cpu(dev, scheme):
    """One crash-matrix cell per scheme (the update cell: logged paths,
    and dense's torn negative control), continuity's resize cell, and the
    store's one-step or split resize: card rows and tables equal CPU."""
    from repro_torch.consistency import matrix
    ops = ("update", "resize") if scheme == "continuity" else ("update",)
    assert (matrix.run_rows([scheme], ops, device="cuda")
            == matrix.run_rows([scheme], ops, device="cpu"))
    K = ycsb.make_key(np.arange(60))
    V = ycsb.make_value(np.random.RandomState(2), 60)
    out = []
    for d in ("cpu", "cuda"):
        store = api.make_store(scheme, table_slots=240, device=d)
        t, _ = store.insert(store.create(), K, V)
        new_store, new_t = store.resize_cutover(store.begin_resize(t))
        out.append(TO_NUMPY[scheme](new_t))
    _assert_fields_equal(*out)


# ---------------------------------------------------------------------------
# the stash index and the cluster layer
# ---------------------------------------------------------------------------

def test_stash_index_on_card_matches_dense_and_cpu(dev):
    """`_stash_find` on the card gives the dense compare's hit and lowest
    index, and the CPU's, on a stash-heavy table with a repeated entry;
    lookup, update and delete there equal the CPU's tables."""
    cfg = ch.ContinuityConfig(num_buckets=256, stash_frac=1 / 8)
    n = int(cfg.num_pairs * cfg.slots_per_pair * 1.02)
    rng = np.random.RandomState(8)
    K, V = ycsb.make_key(np.arange(n)), ycsb.make_value(rng, n)
    t = ch.create(cfg, "cpu")
    ch.insert(cfg, t, K, V)
    ch.delete(cfg, t, K[::10])
    live = (t.stash_meta != 0).nonzero().squeeze(1)
    free = (t.stash_meta == 0).nonzero().squeeze(1)
    for f in ("stash_keys", "stash_vals", "stash_meta"):
        getattr(t, f)[free[-1]] = getattr(t, f)[live[1]]
    Q = ycsb.make_key(rng.randint(0, n + n // 4, size=4096))
    W = ycsb.make_value(rng, 4096)
    out = []
    for d in ("cpu", "cuda"):
        td = ch.ContinuityTable(*(x.clone().to(d) for x in t))
        q = torch.from_numpy(Q.view(np.int32)).to(d)
        pair, _ = ch.locate(cfg, q)
        hit, sidx = ch._stash_find(cfg, td, q, pair)
        dhit, dsidx = ch._stash_find_dense(cfg, td, q, pair)
        assert torch.equal(hit, dhit) and torch.equal(sidx, dsidx)
        look = ch.lookup(cfg, td, q)
        _, uok, _ = ch.update(cfg, td, Q, W, probe="kernel")
        _, dok, _ = ch.delete(cfg, td, Q[::3], probe="kernel")
        out.append((hit.cpu(), sidx.cpu(), look.slot.cpu(), uok.cpu(),
                    dok.cpu(), convert.table_to_numpy(td)))
    (*a, ta), (*b, tb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_fields_equal(ta, tb)
    assert bool(a[0].any())


def test_stash_find_syncs_once(dev):
    """The stash index reads one number back per call (its live-entry
    count, the empty stash's gate), however many entries and queries."""
    import warnings
    cfg = ch.ContinuityConfig(num_buckets=2 ** 15, stash_frac=1 / 8)
    n = int(cfg.num_pairs * cfg.slots_per_pair * 1.02)
    rng = np.random.RandomState(11)
    t = ch.create(cfg, "cuda")
    ch.insert(cfg, t, ycsb.make_key(np.arange(n)),
              ycsb.make_value(rng, n))
    q = torch.from_numpy(ycsb.make_key(np.arange(0, 2 * n, 3)).view(
        np.int32)).cuda()
    pair, _ = ch.locate(cfg, q)
    empty = ch.create(cfg, "cuda")
    with warnings.catch_warnings(record=True):   # a process's first switch
        torch.cuda.set_sync_debug_mode("warn")   # to "warn" reports a sync
        torch.cuda.set_sync_debug_mode("default")
    for table in (t, empty):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                hit, _ = ch._stash_find(cfg, table, q, pair)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert sum("synchroniz" in str(w.message) for w in caught) == 1
        assert bool(hit.any()) == (table is t)
    assert int((t.stash_meta != 0).sum()) > 4096   # past a small sort


def test_device_restart_on_card_matches_cpu(dev):
    """`store.recover` of a table (the failover restart) on the card gives
    the CPU's table and report, repeated stash entries cleared."""
    rng = np.random.RandomState(9)
    K, V = ycsb.make_key(np.arange(46)), ycsb.make_value(rng, 46)
    out = []
    for d in ("cpu", "cuda"):
        store = api.make_store("continuity", table_slots=40, device=d)
        t, _ = store.insert(store.create(), K, V)
        live = (t.stash_meta != 0).nonzero().squeeze(1)
        free = (t.stash_meta == 0).nonzero().squeeze(1)
        for f in ("stash_keys", "stash_meta"):
            getattr(t, f)[free[0]] = getattr(t, f)[live[0]]
        t2, rep = store.recover(t)
        out.append((convert.table_to_numpy(t2), rep))
    _assert_fields_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] and out[1][1].duplicates_cleared == 1


def test_device_routing_on_card_is_bit_exact(dev):
    from repro_torch.cluster import Directory
    rng = np.random.RandomState(10)
    keys = np.concatenate([ycsb.make_key(np.arange(2 ** 19)), rng.randint(
        0, 2 ** 32, size=(2 ** 19, 4), dtype=np.uint64).astype(np.uint32)])
    for members in (("pm0", "pm1", "pm2", "pm3"), ("pm0", "pm1", "pm2",
                                                    "pm3", "pmJ")):
        d = Directory(members, replicas=2)
        got = d.replica_sets_t(torch.from_numpy(keys.view(np.int32)).cuda())
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      d.replica_sets(keys))


def test_cluster_drill_on_card_matches_cpu(dev):
    """The --smoke cluster cell and a partition / stale / heal / resync
    cell on the card equal the CPU's payloads field for field."""
    from repro_torch.cluster import sim
    cells = [sim.smoke_kwargs(True),
             dict(num_records=160, num_ops=240, batch=40, nodes=3,
                  workload="F", dist="hotspot", seed=4,
                  events=(("partition", 60, "pm1"), ("stale", 80, "pm1"),
                          ("heal", 120, "pm1"), ("resync", 160, "pm1")))]
    for kw in cells:
        got = sim.run_cluster(device="cuda", **kw)
        want = sim.run_cluster(device="cpu", **kw)
        assert got == want
        assert got["committed_lost"] == 0


def test_tiny_fanin_on_card_matches_cpu(dev):
    """``tests/test_cache.py``'s tiny fan-in cell with the full chaos
    schedule: the card's payload equals the CPU's field for field."""
    from repro_torch.cache import fanin
    kw = dict(clients=6, rounds=7, ops_per_round=6, writes_per_round=1,
              num_records=300, nodes=3, replicas=2, budget=None,
              events=[(2, "partition", "primary"), (2, "stale", ""),
                      (3, "heal", ""), (4, "resync", ""),
                      (5, "kill", "primary"), (6, "failover", "")])
    got = fanin.run_fanin("continuity", device="cuda", **kw)
    want = fanin.run_fanin("continuity", device="cpu", **kw)
    assert got == want
    assert got["cached"]["stale_served"] == 0
    assert got["cached"]["wrong_reads"] == got["uncached"]["wrong_reads"] == 0


@pytest.mark.parametrize("name,workload", [("partition_fence", "E"),
                                           ("timeout_giveup", "A")])
def test_chaos_cells_on_card_match_cpu(dev, name, workload):
    from repro_torch.chaos import scenarios
    got = scenarios.run_scenario(name, workload=workload, seed=2,
                                 device="cuda")
    want = scenarios.run_scenario(name, workload=workload, seed=2,
                                  device="cpu")
    assert got == want and got["ok"], got["checks"]


# -- the moe, ssm and hybrid families ----------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("B,MAXP", [(16, 34), (4, 3), (7, 9)])
def test_paged_attention_granite_shape(dev, dtype, tol, B, MAXP):
    """granite-moe-3b's decode heads (H 24, KVH 8: G 3, D 64) against the
    plain version, lengths across page boundaries; in bf16 also within
    2 % of the largest plain output at the served length."""
    args = on(attn_case(B * 7 + MAXP, B, 24, 8, 64, 16, MAXP), dev, dtype)
    got = paged_attn.paged_attention(*args).float()
    want = paged_attention_ref(*args).float()
    assert float((got - want).abs().max()) < tol
    if dtype == torch.bfloat16 and B == 16:
        n = 16 * MAXP - 1
        args = on(attn_case(11, B, 24, 8, 64, 16, MAXP, lens=[n] * B,
                            q_scale=4.0), dev, dtype)
        got = K.paged_attention(*args).float()
        want = paged_attention_ref(*args).float()
        assert float((got - want).abs().max()) <= min(
            6e-2, 2e-2 * float(want.abs().max()))


def _to(params, d):
    p = {k: v.to(d) for k, v in params.items() if k != "blocks"}
    p["blocks"] = {k: v.to(d) for k, v in params["blocks"].items()}
    return p


def test_moe_twin_served_on_card_matches_cpu(dev):
    """The granite-moe twin through prefill, 6 decode steps and a release
    on the card (probe, paged attention at G 3, mutate) against the CPU:
    logits within 1e-4, page tables and small fields byte-equal."""
    cfg = smoke_config("granite-moe-3b-a800m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="decode")
    rng = np.random.RandomState(3)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 32)).astype(
        np.int32))
    fed = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 6)).astype(np.int32))
    runs = []
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        geom = KC.make_geometry(cfg, shape, shards=2, page_size=16, device=d)
        n0 = paged_attn.paged_attention.launches
        lg, cache = E.prefill(cfg, geom, p, prompt.to(d),
                              KC.create_cache(geom))
        logits = [lg]
        for i in range(fed.shape[1]):
            lg, cache = E.serve_step(cfg, geom, p, fed[:, i].to(d), cache)
            logits.append(lg)
        assert paged_attn.paged_attention.launches - n0 == (
            fed.shape[1] * cfg.n_layers if d == "cuda" else 0)
        cache = E.release_sequence(geom, cache, 1, 0)
        runs.append((logits, convert.cache_to_numpy(cache)))
    (lc, sc), (lg_, sg) = runs
    for a, b in zip(lc, lg_):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for f in sc["table"]:
        assert np.array_equal(sc["table"][f], sg["table"][f]), f
    for f in ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off"):
        assert np.array_equal(sc[f], sg[f]), f


@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_recurrent_twin_on_card_matches_cpu(dev, name):
    """The ssm and hybrid twins' recurrent serve steps (70 tokens: past
    the hybrid's 64-token window) on the card against the CPU: logits
    within 2e-5, state caches within 2e-5, no kernel launched."""
    cfg = smoke_config(name)
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (2, 70)).astype(np.int32))
    n0 = paged_attn.paged_attention.launches + probe.probe_segments.launches
    runs = []
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        cache = KC.create_state_cache(cfg, 2, 80, dtype=torch.float32,
                                      device=d)
        out = []
        for t in range(toks.shape[1]):
            lg, cache = E.serve_step(cfg, None, p, toks[:, t].to(d), cache)
            out.append(lg.cpu())
        runs.append((out, convert.state_cache_to_numpy(cache)))
    assert paged_attn.paged_attention.launches \
        + probe.probe_segments.launches == n0
    (lc, sc), (lg_, sg) = runs
    for a, b in zip(lc, lg_):
        torch.testing.assert_close(b, a, atol=2e-5, rtol=0)
    assert np.array_equal(sc["seq_lens"], sg["seq_lens"])
    for k in sc:
        np.testing.assert_allclose(sg[k], sc[k], atol=2e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_graphed_step_matches_eager_on_card(dev, name):
    """The launcher's graphed step (``serve.stepper`` on a state cache on
    the card) against eager ``serve_step`` on the card over 70 tokens
    (past the hybrid's 64-token window): logits and state caches within
    2e-5, ``seq_lens`` equal; the graph refuses another cache."""
    from repro_torch.launch import serve
    cfg = smoke_config(name)
    p = _to(T.init_params(cfg, torch.Generator().manual_seed(1)), "cuda")
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (2, 70)).astype(np.int32)).cuda()
    graphed = serve.make_state_cache(cfg, 2, 70, 10, device="cuda")
    eager = serve.make_state_cache(cfg, 2, 70, 10, device="cuda")
    step = serve.stepper(cfg, None, p, graphed)
    assert isinstance(step, serve.GraphedStep)
    for t in range(toks.shape[1]):
        lg, graphed = step(toks[:, t], graphed)
        want, eager = E.serve_step(cfg, None, p, toks[:, t], eager)
        torch.testing.assert_close(lg, want, atol=2e-5, rtol=0)
    sg = convert.state_cache_to_numpy(graphed)
    se = convert.state_cache_to_numpy(eager)
    assert np.array_equal(sg["seq_lens"], se["seq_lens"])
    assert int(sg["seq_lens"][0]) == toks.shape[1]
    for k in se:
        np.testing.assert_allclose(sg[k], se[k], atol=2e-5, rtol=0,
                                   err_msg=k)
    with pytest.raises(ValueError):
        step(toks[:, 0], eager)


@pytest.mark.parametrize("name", ["starcoder2-15b", "minitron-8b",
                                  "qwen1.5-32b", "musicgen-large",
                                  "llava-next-34b", "granite-moe-1b-a400m",
                                  "hymba-1.5b", "mamba2-370m"])
def test_twin_forward_on_card_matches_cpu(dev, name):
    """Each twin's forward (window and causal-skip attention, MoE, SSD)
    on the card against the CPU, within 2e-5."""
    import dataclasses
    cfg = smoke_config(name)
    if name == "starcoder2-15b":
        cfg = dataclasses.replace(cfg, attn_mode="causal_skip")
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(5)
    if cfg.frontend == "embed":
        x = torch.from_numpy(rng.randn(2, 90, cfg.d_model).astype(np.float32))
    else:
        x = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 90)).astype(
            np.int32))
    want, aux = T.forward(cfg, params, x)
    got, aux_g = T.forward(cfg, _to(params, "cuda"), x.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
    torch.testing.assert_close(aux_g.cpu(), aux, atol=2e-5, rtol=0)


# -- int8 KV pages, the merged path, training and checkpoints (slice 10) -----

def int8_case(seed, B, G, D, PS, MAXP, lens, dev, dtype):
    """``attn_case``'s pools quantized by ``quant_store`` (int8 pools and
    float32 scales), on the card; q in ``dtype``."""
    q, kp, vp, pt, ln = attn_case(seed, B, 2 * G, 2, D, PS, MAXP, lens=lens)
    kq, ks = KC.quant_store(kp)
    vq, vs = KC.quant_store(vp)
    return (q.to(dev, dtype), kq.to(dev), vq.to(dev), pt.to(dev), ln.to(dev),
            ks.to(dev), vs.to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("G,D", [(1, 64), (8, 64), (1, 128), (8, 128)])
@pytest.mark.parametrize("splits", [0, 3])
def test_int8_paged_attention_matches_plain(dev, dtype, tol, G, D, splits):
    """The int8 mode against the plain version: lengths 0, 1, on page
    boundaries and one past; a zero-scale row; zeros for length 0; a
    second call bit-identical; one launch counted."""
    PS, MAXP = 16, 6
    q, kq, vq, pt, ln, ks, vs = int8_case(G * D, 7, G, D, PS, MAXP,
                                          [0, 1, PS, PS + 1, 2 * PS,
                                           2 * PS + 1, MAXP * PS], dev, dtype)
    ks[pt[3, 0].long(), 0, 2] = 0.0          # a zero-scale row, mapped
    vs[pt[4, 1].long(), 1, 0] = 0.0
    scale = float(1.0 / D ** 0.5)
    pa = paged_attn.paged_attention
    n0 = pa.launches, pa.int8_launches
    got = (paged_attn.paged_attention(q, kq, vq, pt, ln, kscale=ks,
                                      vscale=vs) if not splits else
           _cuda.launch_paged_attn(q, kq, vq, pt, ln, scale, splits=splits,
                                   kscale=ks, vscale=vs))
    want = paged_attention_ref(q, kq, vq, pt, ln, kscale=ks, vscale=vs)
    torch.cuda.synchronize()
    assert (pa.launches, pa.int8_launches) == (n0[0] + (not splits),
                                               n0[1] + (not splits))
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert float((got[1:].float() - want[1:].float()).abs().max()) < tol
    again = _cuda.launch_paged_attn(q, kq, vq, pt, ln, scale,
                                    splits=splits, kscale=ks, vscale=vs)
    assert torch.equal(again, got)


@pytest.mark.parametrize("D", [128, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_paged_attention_ignores_poisoned_pages(dev, dtype, D):
    """Poison (int8 extremes, huge and NaN scales) in every page not read
    leaves the output bit-identical (D 24: rows staged by 8-byte
    cp.async)."""
    q, kq, vq, pt, ln, ks, vs = int8_case(3, 5, 8, D, 16, 5,
                                          [1, 17, 33, 64, 80], dev, dtype)
    pt[4, 2] = -1                           # a dead page inside a length
    base = paged_attn.paged_attention(q, kq, vq, pt, ln, kscale=ks,
                                      vscale=vs)
    read = torch.zeros(kq.shape[0], dtype=torch.bool, device=dev)
    for b in range(pt.shape[0]):
        ids = pt[b, :-(-int(ln[b]) // 16)]
        read[ids[ids >= 0].long()] = True
    kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
    kq2[~read], vq2[~read] = 127, -127
    ks2[~read], vs2[~read] = 1e30, float("nan")
    out = paged_attn.paged_attention(q, kq2, vq2, pt, ln, kscale=ks2,
                                     vscale=vs2)
    assert torch.equal(out, base)


def test_int8_paged_attention_rejects_operands_it_does_not_take(dev):
    q, kq, vq, pt, ln, ks, vs = int8_case(1, 2, 4, 64, 8, 3, [5, 9], dev,
                                          torch.float32)
    with pytest.raises(ValueError, match="kpool must be torch.int8"):
        paged_attn.paged_attention(q, kq.float(), vq, pt, ln, kscale=ks,
                                   vscale=vs)
    with pytest.raises(ValueError, match="vscale"):
        paged_attn.paged_attention(q, kq, vq, pt, ln, kscale=ks)
    with pytest.raises(ValueError, match="kscale"):
        paged_attn.paged_attention(q, kq, vq, pt, ln, kscale=ks.double(),
                                   vscale=vs)
    with pytest.raises(ValueError, match="kpool must be"):
        paged_attn.paged_attention(q, kq, vq, pt, ln)   # int8, no scales
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="vpool must be torch.int8"):
        paged_attn.paged_attention(qb, kq, vq.bfloat16(), pt, ln, kscale=ks,
                                   vscale=vs)
    buf = torch.empty(kq.numel() + 16, dtype=torch.int8, device=dev)
    shifted = buf[1:1 + kq.numel()].view(kq.shape)    # contiguous, offset 1
    shifted.copy_(kq)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_attn.paged_attention(qb, shifted, vq, pt, ln, kscale=ks,
                                   vscale=vs)
    with pytest.raises(ValueError, match="head dim"):
        paged_attn.paged_attention(qb[..., :60].contiguous(),
                                   kq[..., :60].contiguous(),
                                   vq[..., :60].contiguous(), pt, ln,
                                   kscale=ks, vscale=vs)


# -- the int8 and float32 routes redesigned: their grids ----------------------

ROUTE_GRID = [(G, D, PS) for G in (1, 3, 4, 8) for D in (24, 64, 128)
              for PS in (8, 16)]


def route_case(seed, G, D, PS, dev):
    """B 4 sequences of lengths 0, 1, two pages exactly, and past a dead
    page (an unmapped page inside its length), 2 kv heads of G query
    heads, 9 pages each: (q, kpool, vpool, pt, lens) in float32 and the
    pools through ``quant_store`` (kq, ks, vq, vs), on the card."""
    MAXP = 9
    q, kp, vp, pt, ln = attn_case(seed, 4, 2 * G, 2, D, PS, MAXP,
                                  lens=[0, 1, 2 * PS, 8 * PS + 3],
                                  q_scale=2.0)
    pt[3, 2] = -1
    f32 = on((q, kp, vp, pt, ln), dev, torch.float32)
    (kq, ks), (vq, vs) = KC.quant_store(f32[1]), KC.quant_store(f32[2])
    return f32, (kq, ks, vq, vs)


def host_splits(code, args):
    """The split count the host picks for ``args`` in mode ``code``."""
    q, kp, _, pt, _ = args
    index = q.device.index or 0
    KVH = kp.shape[1]
    return _cuda.paged_attn_splits(
        q.shape[0] * KVH, pt.shape[1], _cuda.sm_count(index),
        _cuda.resident_blocks(index, code, q.shape[2], q.shape[1] // KVH))


@pytest.mark.parametrize("G,D,PS", ROUTE_GRID)
def test_int8_route_equals_bf16_mode_on_dequantized_pools(dev, G, D, PS):
    """Int8 pools under bf16 q run the bf16 kernel's ring and tensor cores
    on rows widened in shared memory: at split counts 1, 3 and the host's,
    its output equals the bf16 mode's on the plain version's dequantized
    pools bit for bit."""
    (q, _, _, pt, ln), (kq, ks, vq, vs) = route_case(G * D + PS, G, D, PS,
                                                      dev)
    qb = q.bfloat16()
    kb, vb = KC.dequant(kq, ks, torch.bfloat16), KC.dequant(vq, vs,
                                                            torch.bfloat16)
    scale = float(1.0 / D ** 0.5)
    host = host_splits(_cuda.PAGED_ATTN_INT8[torch.bfloat16],
                       (qb, kq, vq, pt, ln))
    for splits in (1, 3, host):
        got = _cuda.launch_paged_attn(qb, kq, vq, pt, ln, scale,
                                      splits=splits, kscale=ks, vscale=vs)
        want = _cuda.launch_paged_attn(qb, kb, vb, pt, ln, scale,
                                       splits=splits)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.equal(got, want), splits
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    ref = paged_attention_ref(qb, kq, vq, pt, ln, kscale=ks, vscale=vs)
    assert float((got[1:].float() - ref[1:].float()).abs().max()) < 6e-2


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,D,PS", ROUTE_GRID)
def test_float32_loop_matches_plain(dev, G, D, PS, int8):
    """The CUDA-core loop under float32 q, over float32 pools (dtype 0)
    and int8 pools (dtype 2): within 2e-5 of the plain version at split
    counts 1, 3 and the host's, zeros at length 0, and bit-identical on a
    second launch."""
    (q, kp, vp, pt, ln), (kq, ks, vq, vs) = route_case(G * D + PS + 1, G, D,
                                                        PS, dev)
    args, kw = ((q, kq, vq, pt, ln), {"kscale": ks, "vscale": vs}) if int8 \
        else ((q, kp, vp, pt, ln), {})
    scale = float(1.0 / D ** 0.5)
    want = paged_attention_ref(*args, **kw)
    code = (_cuda.PAGED_ATTN_INT8 if int8 else _cuda.PAGED_ATTN_DTYPES)[
        torch.float32]
    for splits in (1, 3, host_splits(code, args)):
        got = _cuda.launch_paged_attn(*args, scale, splits=splits, **kw)
        again = _cuda.launch_paged_attn(*args, scale, splits=splits, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, again), splits
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert float((got[1:] - want[1:]).abs().max()) < 2e-5, splits


@pytest.mark.parametrize("splits", [1, 3])
def test_paged_attention_poison_float32_bit_identical(dev, splits):
    """Poison (1e3, -1e3, NaN) in every float32 page not read (unmapped,
    or mapped past the length) leaves the CUDA-core loop's output
    bit-identical."""
    q, kp, vp, pt, lens = split_case(dev, torch.float32, 3, G=3, D=64,
                                     seed=9)
    free = sorted(set(range(kp.shape[0])) - set(pt.flatten().tolist()))
    pt[3, -1] = free[0]               # mapped, but past that length
    scale = float(1.0 / q.shape[-1] ** 0.5)
    base = _cuda.launch_paged_attn(q, kp, vp, pt, lens, scale, splits=splits)
    read = torch.zeros(kp.shape[0], dtype=torch.bool, device=dev)
    for b in range(pt.shape[0]):
        ids = pt[b, :-(-int(lens[b]) // kp.shape[2])]
        read[ids[ids >= 0].long()] = True
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[~read], vp2[~read] = 1e3, float("nan")
    out = _cuda.launch_paged_attn(q, kp2, vp2, pt, lens, scale,
                                  splits=splits)
    assert torch.equal(out, base)


def test_float32_launches_counted(dev):
    """The wrapper counts float32-q launches (the CUDA-core loop) apart:
    float32 pools and int8 pools under float32 q, not bf16 q."""
    (q, kp, vp, pt, ln), (kq, ks, vq, vs) = route_case(5, 8, 64, 16, dev)
    pa = paged_attn.paged_attention
    n0 = pa.launches, pa.float32_launches, pa.int8_launches
    pa(q, kp, vp, pt, ln)
    pa(q, kq, vq, pt, ln, kscale=ks, vscale=vs)
    pa(q.bfloat16(), kq, vq, pt, ln, kscale=ks, vscale=vs)
    assert (pa.launches - n0[0], pa.float32_launches - n0[1],
            pa.int8_launches - n0[2]) == (3, 2, 2)


def test_granite_moe_layer_bit_identical_on_card(dev):
    """Granite-moe-3b's MoE layer at its published widths (d 1536, 40
    experts top-8 of d_ff 512), sorted dispatch at capacity 1.25, bf16:
    two runs on the same input give the same bits (the combine adds in a
    fixed order, no atomics)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = get_arch("granite-moe-3b-a800m")
    m, E_ = cfg.moe, cfg.d_model
    g = torch.Generator(dev).manual_seed(0)
    p = {"router": torch.randn(E_, m.num_experts, generator=g, device=dev)
         * 0.02}
    for name, shape in (("we_gate", (E_, m.expert_dff)),
                        ("we_up", (E_, m.expert_dff)),
                        ("we_down", (m.expert_dff, E_))):
        p[name] = (torch.randn(m.num_experts, *shape, generator=g,
                               device=dev) * 0.02).bfloat16()
    x = torch.randn(16, 256, E_, generator=g, device=dev).bfloat16()
    (a, aux_a), (b, aux_b) = L.moe(cfg, p, x), L.moe(cfg, p, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert bool(a.float().isfinite().all())


def test_int8_serve_steps_on_card_match_cpu(dev):
    """Int8 prefill and decode on the card (the int8 kernel) against the
    CPU (plain version), then one merged-path step that launches no
    attention kernel: logits within 1e-4, page tables byte-equal, int8
    pools equal in 99.9 % of entries and never more than 1 apart."""
    import dataclasses
    cfg = smoke_config("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 32)).astype(
        np.int32))
    fed = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 6)).astype(np.int32))
    runs = []
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        geom = KC.make_geometry(cfg, ShapeConfig("t", 128, 4, "decode"),
                                shards=2, page_size=16, kv_dtype="int8",
                                device=d)
        pa = paged_attn.paged_attention
        n0 = pa.launches, pa.int8_launches
        lg, cache = E.prefill(cfg, geom, p, prompt.to(d),
                              KC.create_cache(geom))
        logits = [lg]
        for i in range(fed.shape[1] - 1):
            lg, cache = E.serve_step(cfg, geom, p, fed[:, i].to(d), cache)
            logits.append(lg)
        n = (fed.shape[1] - 1) * cfg.n_layers if d == "cuda" else 0
        assert (pa.launches - n0[0], pa.int8_launches - n0[1]) == (n, n)
        merged = dataclasses.replace(geom, merged_attn=True)
        n0 = pa.launches, pa.int8_launches
        lg, cache = E.serve_step(cfg, merged, p, fed[:, -1].to(d), cache)
        assert (pa.launches, pa.int8_launches) == n0
        logits.append(lg)
        runs.append((logits, convert.cache_to_numpy(cache)))
    (lc, sc), (lg_, sg) = runs
    for a, b in zip(lc, lg_):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    for f in sc["table"]:
        assert np.array_equal(sc["table"][f], sg["table"][f]), f
    for f in ("kpool", "vpool"):
        diff = np.abs(sg[f].astype(np.int32) - sc[f].astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, f
    for f in ("kscale", "vscale"):
        np.testing.assert_allclose(sg[f], sc[f], rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["yi-6b", "granite-moe-1b-a400m",
                                  "mamba2-370m"])
def test_train_steps_on_card_match_cpu(dev, name):
    """From the same float32 masters (two microbatches, remat full): the
    first step's gradients on the card within 1e-4 of each leaf's largest
    |g| on the CPU, and three AdamW steps' losses within 1e-4 relative.
    (The parameters are not compared: Adam's normalised step turns a
    last-bit difference of a near-zero gradient into a move of up to lr.)"""
    import dataclasses
    from repro_torch.launch import train as launch_train
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import (make_train_step,
                                                 microbatch_grads)
    cfg = dataclasses.replace(smoke_config(name), remat="full")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           master_dtype=torch.float32)
    step_fn = make_train_step(cfg, O.OptConfig(lr=1e-3, warmup=2),
                              num_micro=2)
    runs = []
    for d in ("cpu", "cuda"):
        # copies: the optimizer updates its parameters in place
        p = O.tree_map(lambda t: t.to(d, copy=True), params)
        s = O.init(p)
        batches = [launch_train.synthetic_batch(cfg, 0, i, 4, 48, d)
                   for i in range(3)]
        _, grads = microbatch_grads(cfg, p, batches[0], 2, torch.float32)
        losses = []
        for b in batches:
            p, s, stats = step_fn(p, s, b)
            losses.append(float(stats["loss"]))
        runs.append((losses, dict(O.leaves(grads))))
    (lc, gc), (lg, gg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k, a in gc.items():
        lim = 1e-4 * float(a.abs().max())
        assert float((gg[k].cpu() - a).abs().max()) <= lim, k


def test_checkpoint_from_card_restores_onto_card(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training import optimizer as O
    cfg = smoke_config("yi-6b")
    p = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                      master_dtype=torch.float32)
    state = O.init(p)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, {"p": p, "o": state})
    saved = {k: t.clone() for k, t in O.leaves(p)}
    for _, t in O.leaves(p):
        t.add_(1.0)                      # after the save: not in it
    mgr.wait()
    template = {"p": T.init_params(cfg, torch.Generator(dev).manual_seed(1),
                                   master_dtype=torch.float32),
                "o": O.init(p)}
    got, step, _ = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 2 and got["o"].step.device.type == "cuda"
    for k, t in O.leaves(got["p"]):
        assert t.device.type == "cuda"
        assert torch.equal(t, saved[k]), k


def routed_case(seed, P, N, dev):
    """A local ext-free table with live items (random words, random
    indicator bits) and N routed entries over its pairs: inserts,
    updates, deletes of present and absent keys, one key repeated, dead
    and no-op entries; (cfg, table, (pair, parity, op, keys, vals, live))."""
    rng = np.random.RandomState(seed)
    cfg = ch.ContinuityConfig(num_buckets=2 * P, ext_frac=0.0)
    S = cfg.slots_per_pair
    fields = {f: np.asarray(v) for f, v in convert.table_to_numpy(
        ch.create(cfg, "cpu")).items()}
    fields["keys"] = rng.randint(0, 2 ** 32, (P, S, 4), dtype=np.uint64)
    fields["vals"] = rng.randint(0, 2 ** 32, (P, S, 4), dtype=np.uint64)
    fields["indicator"] = rng.randint(0, 2 ** 20, P, dtype=np.uint64)
    fields["version"] = rng.randint(0, 2 ** 32, P, dtype=np.uint64)
    fields = {k: (v.astype(np.uint32) if v.dtype == np.uint64 else v)
              for k, v in fields.items()}
    table = convert.table_from_numpy(fields, dev)
    pair = rng.randint(0, P, N)
    k = rng.randint(0, 2 ** 32, (N, 4), dtype=np.uint64)
    present = rng.rand(N) < 0.5
    k[present] = fields["keys"][pair[present], rng.randint(0, S, N)[present]]
    k[N // 2:N // 2 + 8] = k[0]
    pair[N // 2:N // 2 + 8] = pair[0]
    parity = rng.randint(0, 2, N)
    parity[N // 2:N // 2 + 8] = parity[0]
    ent = (torch.from_numpy(pair.astype(np.int32)).to(dev),
           torch.from_numpy(parity.astype(np.int32)).to(dev),
           torch.from_numpy(rng.randint(0, 4, N).astype(np.int32)).to(dev),
           words(k, dev), words(rng.randint(0, 2 ** 32, (N, 4),
                                            dtype=np.uint64), dev),
           torch.from_numpy(rng.rand(N) < 0.9).to(dev))
    return cfg, table, ent


@pytest.mark.parametrize("seed,P,N", [(0, 4, 96), (1, 64, 4_096),
                                      (2, 1_024, 33), (3, 2, 512)])
def test_routed_walk_matches_plain(dev, seed, P, N):
    cfg, table, ent = routed_case(seed, P, N, dev)
    host = ch.ContinuityTable(*(t.cpu() for t in table))
    want = scan_walk.routed_write(cfg, host, *(t.cpu() for t in ent))
    outs = []
    for _ in range(2):                      # bit-identical on relaunch
        t = ch.ContinuityTable(*(x.clone() for x in table))
        n0 = scan_walk.scan_walk.launches
        status = scan_walk.routed_write(cfg, t, *ent)
        assert scan_walk.scan_walk.launches == n0 + 1
        outs.append((status.cpu(), convert.table_to_numpy(t)))
    mine = convert.table_to_numpy(host)
    for status, fields in outs:
        assert torch.equal(status, want)
        for f, a in mine.items():
            if a is not None:
                assert np.array_equal(fields[f], a), f
    assert 0 < int(want.sum()) < N


def test_routed_walk_rejects_what_it_does_not_take(dev):
    cfg, table, ent = routed_case(0, 4, 8, dev)
    with pytest.raises(ValueError):
        scan_walk.routed_write(ch.ContinuityConfig(num_buckets=8), table,
                               *ent)
    with pytest.raises(ValueError):
        scan_walk.routed_write(cfg, table, *ent[:5], ent[5].int())
    n0 = scan_walk.scan_walk.launches
    out = scan_walk.routed_write(cfg, table, *(t[:0] for t in ent))
    assert out.shape == (0,) and scan_walk.scan_walk.launches == n0


def test_world1_nccl_store_equals_unsharded_store(dev):
    """The sharded store on a world-1 NCCL group: inserts to load 0.6,
    updates and deletes, every key read back equal to the unsharded
    store's table of the same geometry driven by the same acknowledged
    writes."""
    import socket
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        scfg = D.StoreConfig(table=ch.ContinuityConfig(num_buckets=2 ** 12,
                                                       ext_frac=0.0),
                             num_shards=1)
        mesh = make_debug_mesh((1,), ("data",), device_type="cuda")
        write, lookup = D.make_write(scfg, mesh), D.make_lookup(scfg, mesh)
        table = D.create_sharded(scfg, "cuda")
        rng = np.random.RandomState(5)
        N = int(0.6 * 2 ** 11 * 16)
        keys = words(rng.randint(0, 2 ** 32, (N, 4), dtype=np.uint64), dev)
        vals = words(rng.randint(0, 2 ** 32, (N, 4), dtype=np.uint64), dev)
        ins = torch.full((N,), D.OP_INSERT, dtype=torch.int32, device=dev)
        _, ok, routed = write(table, ins, keys, vals)
        assert bool(routed.all()) and 0.99 * N < int(ok.sum()) <= N
        upd = torch.full((N,), D.OP_UPDATE, dtype=torch.int32, device=dev)
        upd[N // 2:] = D.OP_DELETE
        vals2 = vals.flip(0).contiguous()
        _, ok2, _ = write(table, upd, keys, vals2)
        assert int(D.sharded_count(table)) == \
            int(ok.sum()) - int((ok2 & (upd == D.OP_DELETE)).sum())
        r = lookup(table, keys)
        # the unsharded store: the acknowledged inserts, then the
        # acknowledged updates and deletes
        store = api.make_store("continuity", num_buckets=2 ** 12,
                               ext_frac=0.0, stash_frac=0.0, device="cuda")
        flat = store.create()
        _, res = store.insert(flat, keys[ok], vals[ok])
        assert bool(res.ok.all())
        half = torch.arange(N, device=dev) < N // 2
        _, res = store.update(flat, keys[ok2 & half], vals2[ok2 & half])
        assert bool(res.ok.all())
        _, res = store.delete(flat, keys[ok2 & ~half])
        assert bool(res.ok.all())
        want = store.lookup(flat, keys)
        assert torch.equal(r.found, want.ok)
        assert torch.equal(r.values[r.found], want.values[want.ok])
        assert int(r.ledger.ops) == N and int(r.ledger.rdma_reads) == N
    finally:
        dist.destroy_process_group()
