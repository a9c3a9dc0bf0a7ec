"""The PyTorch port's hashing and segment-kernel plain versions against the
JAX package, on the CPU.

Inputs come from numpy seeds and go through both sides; integer outputs
must match exactly.  The JAX kernels run as the JAX package's own tests
run them here (Pallas interpret mode), and against their jnp oracles.
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashfn as jh
from repro.kernels.mutate import mutate_segments as jax_mutate_segments
from repro.kernels.mutate_ref import mutate_ref as jax_mutate_ref
from repro.kernels.probe import probe_segments as jax_probe_segments
from repro.kernels.probe_ref import probe_ref as jax_probe_ref
from repro_torch.core import hashfn as th
from repro_torch.kernels import _cuda
from repro_torch.kernels import mutate as tmutate
from repro_torch.kernels import probe as tprobe
from repro_torch.kernels.mutate_ref import mutate_ref
from repro_torch.kernels.probe_ref import probe_ref

BIG = 0x7FFFFFFF


def words(a) -> torch.Tensor:
    """numpy uint32/int32 array -> the port's int32 word tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(x) -> np.ndarray:
    """Either side's output as uint32 values, for exact comparison."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 \
        else a


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _hash_keys():
    rng = np.random.RandomState(11)
    k = rng.randint(0, 2 ** 32, size=(257, 4), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[-1] = 0xFFFFFFFF                       # all-ones lanes
    k[-2] = 0
    k[-3, ::2] = 0xFFFFFFFF
    return k


@pytest.mark.parametrize("fn", ["hash128", "hash128_2"])
def test_key_hashes_match_reference(fn):
    k = _hash_keys()
    want = np.asarray(getattr(jh, fn)(jnp.asarray(k)))
    got = getattr(th, fn)(words(k))
    np.testing.assert_array_equal(u32(got), want)


def test_word_mixers_match_reference():
    k = _hash_keys()
    a, b = k[:, 0], k[:, 3]
    np.testing.assert_array_equal(
        u32(th.fmix32(words(a))), np.asarray(jh.fmix32(jnp.asarray(a))))
    np.testing.assert_array_equal(
        u32(th.mix_pair(words(a), words(b))),
        np.asarray(jh.mix_pair(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        u32(th.fold_u32(words(k))), np.asarray(jh.fold_u32(jnp.asarray(k))))


# ---------------------------------------------------------------------------
# segment probe / mutation plan: plain versions vs the JAX kernels
# ---------------------------------------------------------------------------

def make_probe_case(rng, P, S, B, fill=None):
    """The JAX kernel tests' case shapes; ``fill`` sets every indicator
    word (0 = all empty, 0xFFFFF = all 20 main bits), else random words
    with bit 31 set on every other pair."""
    KL = 4
    rows = rng.randint(0, 2 ** 31, size=(P, S * KL)).astype(np.uint32)
    if fill is None:
        ind = rng.randint(0, 2 ** S if S < 31 else 2 ** 31,
                          size=(P, 1)).astype(np.uint32)
        ind[::2] |= np.uint32(1 << 31)
    else:
        ind = np.full((P, 1), fill, np.uint32)
    seg = (S * 4) // 5
    prio = np.full((2, S), BIG, np.int32)
    prio[0, :seg] = np.arange(seg)
    prio[1, list(range(S - 1, S - 1 - seg, -1))] = np.arange(seg)
    pairs = rng.randint(0, P, size=(B,)).astype(np.int32)
    parity = rng.randint(0, 2, size=(B,)).astype(np.int32)
    qkeys = rng.randint(0, 2 ** 31, size=(B, KL)).astype(np.uint32)
    for i in range(0, B, 2):                 # half the queries are present
        s = rng.randint(0, S)
        qkeys[i] = rows[pairs[i], s * KL:(s + 1) * KL]
    fps = rng.randint(0, 2 ** 32, size=(P, 2), dtype=np.uint64)
    fps = fps.astype(np.uint32)
    qfp = rng.randint(0, 4, size=(B,)).astype(np.uint32)
    # plant the right field under half of the planted keys so the fp
    # filter both passes and rejects true key matches
    for i in range(0, B, 4):
        seg_row = rows[pairs[i]].reshape(S, KL)
        hit = np.nonzero((seg_row == qkeys[i]).all(-1))[0]
        if len(hit):
            s = int(hit[0])
            lane, sh = s // 16, 2 * (s % 16)
            fps[pairs[i], lane] = (fps[pairs[i], lane]
                                   & ~np.uint32(3 << sh)) \
                | np.uint32(int(qfp[i]) << sh)
    return rows, ind, prio, pairs, parity, qkeys, fps, qfp


CASES = [(8, 20, 16, None), (16, 10, 33, None), (64, 30, 7, None),
         (8, 20, 32, 0), (8, 20, 32, 0xFFFFF)]


@pytest.mark.parametrize("P,S,B,fill", CASES)
@pytest.mark.parametrize("use_fp", [False, True], ids=["nofp", "fp"])
def test_probe_plain_matches_jax_kernel(P, S, B, fill, use_fp):
    rng = np.random.RandomState(P * 1000 + B)
    rows, ind, prio, pairs, parity, qkeys, fps, qfp = make_probe_case(
        rng, P, S, B, fill)
    jargs = [jnp.asarray(a) for a in (rows, ind, prio, pairs, parity, qkeys)]
    targs = [words(rows), words(ind), torch.from_numpy(prio),
             torch.from_numpy(pairs), torch.from_numpy(parity), words(qkeys)]
    jfp = (jnp.asarray(fps), jnp.asarray(qfp)) if use_fp else ()
    tfp = (words(fps), words(qfp)) if use_fp else ()
    mk, ek = jax_probe_segments(*jargs, *jfp)        # Pallas, interpret mode
    mr, er = jax_probe_ref(*jargs, *jfp)
    m, e = probe_ref(*targs, *tfp)
    assert m.dtype == e.dtype == torch.int32
    for want in ((mk, ek), (mr, er)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(e.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("P,S,B,fill", CASES)
def test_mutate_plain_matches_jax_kernel(P, S, B, fill):
    rng = np.random.RandomState(P * 1000 + B + 1)
    rows, ind, prio, pairs, parity, qkeys, fps, qfp = make_probe_case(
        rng, P, S, B, fill)
    jargs = [jnp.asarray(a) for a in
             (rows, ind, fps, prio, pairs, parity, qkeys, qfp)]
    targs = [words(rows), words(ind), words(fps), torch.from_numpy(prio),
             torch.from_numpy(pairs), torch.from_numpy(parity), words(qkeys),
             words(qfp)]
    got = mutate_ref(*targs)
    for want in (jax_mutate_segments(*jargs), jax_mutate_ref(*jargs)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(u32(g), u32(w))


def test_wrappers_run_plain_version_on_cpu_without_counting():
    """On a CPU tensor the kernel wrappers return the plain version's
    result and count no launch: a launch happens only on the card."""
    rng = np.random.RandomState(5)
    rows, ind, prio, pairs, parity, qkeys, fps, qfp = make_probe_case(
        rng, 8, 20, 33)
    args = [words(rows), words(ind), torch.from_numpy(prio),
            torch.from_numpy(pairs), torch.from_numpy(parity), words(qkeys)]
    n_probe = tprobe.probe_segments.launches
    n_mut = tmutate.mutate_segments.launches
    for fp in ((), (words(fps), words(qfp))):
        got = tprobe.probe_segments(*args, *fp)
        want = probe_ref(*args, *fp)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    margs = [args[0], args[1], words(fps), *args[2:], words(qfp)]
    got = tmutate.mutate_segments(*margs)
    assert all(torch.equal(g, w) for g, w in zip(got, mutate_ref(*margs)))
    assert tprobe.probe_segments.launches == n_probe
    assert tmutate.mutate_segments.launches == n_mut
    with pytest.raises(ValueError, match="fps and qfp"):
        tprobe.probe_segments(*args, words(fps))


# ---------------------------------------------------------------------------
# the CUDA kernel's grid and tile walk (host side)
# ---------------------------------------------------------------------------

def probe_walk(B, blocks, tile):
    """The queries each warp of the segment-probe grid takes, as tiles, in
    the order the CUDA kernels walk them (``csrc/segment_probe.cu``): warp
    ``w`` takes tiles ``w, w + warps of the grid, ...``; tile ``t`` holds
    queries ``[t * size, (t + 1) * size)`` cut at ``B``, ``size`` being
    ``tile``, or 1 for tile 0 (one warp per query)."""
    tiles = -(-B // (tile or 1))
    warps = blocks * _cuda.PROBE_WARPS
    return [list(range(w, tiles, warps)) for w in range(warps)]


@pytest.mark.parametrize("B", [1, 31, 33, 4224, 8449, 65536, 1048576])
@pytest.mark.parametrize("resident", [1, 2, 3])
def test_probe_grid_covers_every_query_once_in_one_wave(B, resident):
    """The host's grid is one wave at most, has work for every warp but
    the last block's, and its walk covers every query exactly once."""
    sms, warps, direct = 132, _cuda.PROBE_WARPS, 8
    blocks, tile = _cuda.probe_grid(B, sms, resident, direct)
    size = tile or 1
    assert 1 <= blocks <= (resident if tile else direct) * sms
    assert 0 <= tile <= _cuda.PROBE_TILE and tile & (tile - 1) == 0
    walk = probe_walk(B, blocks, tile)
    assert len(walk) == blocks * warps
    assert all(walk[w] for w in range((blocks - 1) * warps))
    if not tile:
        assert all(len(w) <= 1 for w in walk)   # one query per warp
    seen = np.zeros(B, np.int64)
    for tiles in walk:
        for t in tiles:
            seen[t * size:(t + 1) * size] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,want", [
    (1, (1, 0)),                     # one query, one warp
    (4224, (528, 0)),                # serving's batch: a warp per query
    (8448, (1056, 0)),               # the most one wave of them covers
    (8449, (133, 8)),                # then tiles, small enough to spread
    (16897, (133, 16)),
    (65536, (256, 32)),              # a full tile for (nearly) every warp
    (1048576, (264, 32)),            # the store's read-back: one wave
])
def test_probe_grid_at_the_main_paths_sizes(B, want):
    """A batch that one wave of one-warp-per-query blocks covers takes
    that kernel; a larger one tiles, small tiles on every warp of the wave
    first, tiles of 32 on one wave for a large batch."""
    assert _cuda.probe_grid(B, 132, 2, 8) == want
