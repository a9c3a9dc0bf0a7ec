"""The port's paged attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), the JAX plain version, and the port's
``ops.paged_attention`` — whose wrapper runs its plain version on a CPU
tensor.  Tolerances are those of ``tests/test_kernels.py``: float32 2e-5,
bfloat16 6e-2.  The CUDA kernel itself is held against the port's plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

``split_combine`` below mirrors the CUDA kernel's split-KV arithmetic in
plain PyTorch (float32 partials per split of the page range, merged in
split order), so the split-and-merge scheme is held against the JAX
package here, where the kernel itself cannot run.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged_attn_ref import paged_attention_ref as jax_ref
from repro_torch.kernels import _cuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attn

ROOT = Path(__file__).resolve().parent.parent
DTYPES = [(jnp.float32, torch.float32, 2e-5), (jnp.bfloat16, torch.bfloat16,
                                               6e-2)]


def make_case(rng, B, H, KVH, D, PS, MAXP, lens=None):
    NP = B * MAXP + 2
    q = (rng.randn(B, H, D) * 0.5).astype(np.float32)
    kp = (rng.randn(NP, KVH, PS, D) * 0.3).astype(np.float32)
    vp = rng.randn(NP, KVH, PS, D).astype(np.float32)
    pt = np.full((B, MAXP), -1, np.int32)
    if lens is None:
        lens = rng.randint(1, MAXP * PS, size=(B,))
    lens = np.asarray(lens, np.int32)
    perm = rng.permutation(NP)
    c = 0
    for b in range(B):
        for p in range(int(np.ceil(lens[b] / PS))):
            pt[b, p] = perm[c]
            c += 1
    return q, kp, vp, pt, lens


def both(args, jdt, tdt):
    q, kp, vp, pt, lens = args
    j = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
         jnp.asarray(pt), jnp.asarray(lens))
    t = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
         torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
         torch.from_numpy(lens))
    return j, t


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.to(torch.float32).numpy())))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("B,H,KVH,D,PS,MAXP", [
    (2, 4, 1, 16, 8, 3),
    (3, 8, 2, 32, 16, 4),
    (1, 16, 4, 64, 32, 2),
    (4, 4, 4, 16, 8, 5),       # MHA (G=1)
])
def test_matches_jax_kernel_and_oracle(jdt, tdt, tol, B, H, KVH, D, PS, MAXP):
    rng = np.random.RandomState(B * 100 + H)
    (jq, jk, jv, jpt, jl), targs = both(make_case(rng, B, H, KVH, D, PS, MAXP),
                                        jdt, tdt)
    n0 = paged_attn.paged_attention.launches
    got = tops.paged_attention(*targs)
    assert got.dtype == tdt and got.shape == (B, H, D)
    assert paged_attn.paged_attention.launches == n0   # CPU: plain version
    assert err(jops.paged_attention(jq, jk, jv, jpt, jl), got) < tol
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < tol
    plain = tops.paged_attention(*targs, use_kernel=False)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_lengths_on_page_boundaries(jdt, tdt, tol):
    """Lengths exactly on a page boundary and one past it (a page holding a
    single live token)."""
    rng = np.random.RandomState(11)
    PS, MAXP = 8, 4
    (jq, jk, jv, jpt, jl), targs = both(
        make_case(rng, 6, 8, 1, 32, PS, MAXP,
                  lens=[PS, PS + 1, 2 * PS, 2 * PS + 1, 1, MAXP * PS]),
        jdt, tdt)
    got = tops.paged_attention(*targs)
    assert err(jops.paged_attention(jq, jk, jv, jpt, jl), got) < tol
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < tol


def test_ignores_dead_pages():
    """Garbage in unmapped pool pages, and pages past the length, must not
    reach the output (the reference's poison test, same inputs)."""
    rng = np.random.RandomState(7)
    B, H, KVH, D, PS, MAXP, NP = 2, 4, 2, 16, 8, 4, 16
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(NP, KVH, PS, D).astype(np.float32)
    vp = rng.randn(NP, KVH, PS, D).astype(np.float32)
    pt = np.full((B, MAXP), -1, np.int32)
    pt[:, 0] = [0, 1]
    lens = np.array([5, 3], np.int32)
    t = torch.from_numpy
    base = tops.paged_attention(t(q), t(kp), t(vp), t(pt), t(lens))
    jbase = np.asarray(jops.paged_attention(*map(jnp.asarray,
                                                 (q, kp, vp, pt, lens))))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[2:] = 1e3
    vp2[2:] = -1e3                      # poison every unmapped page
    out = tops.paged_attention(t(q), t(kp2), t(vp2), t(pt), t(lens))
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), jbase, atol=2e-5)


def split_combine(q, kp, vp, pt, lens, splits):
    """The split kernel's arithmetic in plain PyTorch: for each split of
    the page range (``_cuda.split_pages``) a float32 (m, l, acc) per query
    head over its live tokens (m = -inf, l = 0 for none), then the merge in
    split order, skipping empty splits; acc / max(l, 1e-30)."""
    B, H, D = q.shape
    NP, KVH, PS, _ = kp.shape
    MAXP = pt.shape[1]
    G = H // KVH
    scale = float(1.0 / (D ** 0.5))
    idx = pt.clamp(0, NP - 1).long()
    k = kp[idx].movedim(2, 1).reshape(B, KVH, MAXP * PS, D).float()
    v = vp[idx].movedim(2, 1).reshape(B, KVH, MAXP * PS, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, KVH, G, D).float(),
                     k) * scale
    pos = torch.arange(MAXP * PS)[None]
    live = (pos < lens[:, None]) & torch.repeat_interleave(
        (pt >= 0) & (pt < NP), PS, dim=1)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    neg = torch.full((B, KVH, G), float("-inf"))
    parts = []
    for p0, p1 in _cuda.split_pages(MAXP, splits):
        ss = s[..., p0 * PS:p1 * PS]
        m = ss.amax(-1) if p1 > p0 else neg
        p = torch.exp(ss - torch.where(m == float("-inf"), 0.0, m)[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgt,bktd->bkgd", p,
                                   v[:, :, p0 * PS:p1 * PS])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    acc = torch.zeros(B, KVH, G, D)
    for m, l, a in parts:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - torch.where(
            M == float("-inf"), 0.0, M)))
        L = L + w * l
        acc = acc + w[..., None] * a
    return (acc / L.clamp(min=1e-30)[..., None]).reshape(B, H, D).to(q.dtype)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("splits", [1, 2, 3, 6])     # 6 = MAXP + 1
def test_split_combine_matches_jax(jdt, tdt, tol, splits):
    """Split and merge against the JAX kernel (interpret mode) and the JAX
    plain version: a length of 0 (zeros, as the JAX kernel; the plain
    version's softmax over nothing is NaN), 1, full, and lengths on,
    one before and one past each split boundary."""
    PS, MAXP = 8, 5
    edges = [e * PS for _, e in _cuda.split_pages(MAXP, splits)
             if 0 < e < MAXP]
    lens = [0, 1, MAXP * PS] + [x for e in edges for x in (e - 1, e, e + 1)]
    rng = np.random.RandomState(splits)
    (jq, jk, jv, jpt, jl), targs = both(
        make_case(rng, len(lens), 8, 2, 16, PS, MAXP, lens=lens), jdt, tdt)
    got = split_combine(*targs, splits)
    assert got.dtype == tdt
    live = np.asarray(lens) > 0
    assert err(jops.paged_attention(jq, jk, jv, jpt, jl), got) < tol
    assert not got[~live].any()
    want = np.asarray(jax_ref(jq, jk, jv, jpt, jl), np.float32)[live]
    assert err(want, got[live]) < tol


def test_split_combine_unmapped_page_at_a_split_boundary():
    """An unmapped page where a split begins: that split's first page adds
    nothing, as in the JAX kernel."""
    PS, MAXP = 8, 6
    rng = np.random.RandomState(3)
    q, kp, vp, pt, lens = make_case(rng, 3, 4, 1, 16, PS, MAXP,
                                    lens=[MAXP * PS, 4 * PS - 1, 2 * PS + 1])
    pt[:, 2] = -1                       # splits of 2 pages: page 2 opens #2
    (jq, jk, jv, jpt, jl), targs = both((q, kp, vp, pt, lens), jnp.float32,
                                        torch.float32)
    got = split_combine(*targs, 3)
    assert err(jops.paged_attention(jq, jk, jv, jpt, jl), got) < 2e-5
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < 2e-5


@pytest.mark.parametrize("seq_heads", [1, 4, 16, 128, 1000])
@pytest.mark.parametrize("max_pages", [1, 2, 9, 132, 513])
@pytest.mark.parametrize("sms", [1, 132])
def test_split_count_covers_every_page_once(seq_heads, max_pages, sms):
    for resident in (1, 2, 3):   # blocks per SM (bf16: 1 at D 256, 2 at 128)
        splits = _cuda.paged_attn_splits(seq_heads, max_pages, sms, resident)
        assert 1 <= splits <= max_pages
        ranges = _cuda.split_pages(max_pages, splits)
        assert all(b < e for b, e in ranges)          # no split without a page
        assert [p for b, e in ranges for p in range(b, e)] == list(
            range(max_pages))
        want = resident * sms // seq_heads
        assert 2 * splits >= min(max_pages, want)     # near one wave
        assert seq_heads * splits <= max(seq_heads, resident * sms)


def test_split_count_at_serving_sizes():
    """Yi-6B (4 kv heads, 132 pages) on 132 SMs, two bf16 blocks resident
    per SM at D 128: 2 splits at batch 32 (256 blocks), 15 at the
    launcher's default batch of 4 (240 blocks); one block per SM (D 256)
    halves the wave."""
    assert _cuda.paged_attn_splits(32 * 4, 132, 132, 2) == 2
    assert _cuda.paged_attn_splits(4 * 4, 132, 132, 2) == 15
    assert _cuda.paged_attn_splits(32 * 4, 132, 132, 1) == 1
    assert _cuda.paged_attn_splits(4 * 4, 132, 132, 1) == 8


def slice_pools(kp, vp, m, r):
    """Rank ``r``'s slice of each page's tokens, of ``m`` slices."""
    n = kp.shape[2] // m
    return (kp[:, :, r * n:(r + 1) * n].contiguous(),
            vp[:, :, r * n:(r + 1) * n].contiguous())


def sliced(q, kp, vp, pt, lens, m):
    """The plain slice mode over ``m`` slices of each page, every slice's
    partials merged in slice order."""
    PS = kp.shape[2]
    parts = [tops.paged_attention(q, *slice_pools(kp, vp, m, r), pt, lens,
                                  page_stride=PS,
                                  token_offset=r * (PS // m))
             for r in range(m)]
    return tops.merge_partials(torch.cat([a for a, _ in parts], 2),
                               torch.cat([b for _, b in parts], 2), q.dtype)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("B,H,KVH,D,PS,MAXP,lens", [
    (7, 8, 2, 32, 16, 4, [1, 3, 16, 17, 21, 40, 64]),   # empty slices
    (3, 4, 4, 16, 8, 5, None),                          # MHA (G=1)
    (4, 16, 2, 64, 32, 3, [5, 33, 70, 96]),
])
def test_slices_merge_to_the_unsliced_plain_version(jdt, tdt, tol, m, B, H,
                                                     KVH, D, PS, MAXP, lens):
    """The plain slice mode plus the merge over m slices equals the
    unsliced plain version (bit for bit at m = 1, within the dtype's
    tolerance otherwise, float32 2e-5) and the JAX package's plain
    version; short sequences leave whole slices with no live token."""
    rng = np.random.RandomState(B * 10 + m)
    (jq, jk, jv, jpt, jl), targs = both(
        make_case(rng, B, H, KVH, D, PS, MAXP, lens=lens), jdt, tdt)
    n0 = paged_attn.paged_attention.launches
    got = sliced(*targs, m)
    assert paged_attn.paged_attention.launches == n0   # CPU: plain version
    assert got.dtype == tdt and got.shape == (B, H, D)
    want = tops.paged_attention(*targs)
    if m == 1:
        assert torch.equal(got, want)
    assert err(want.float().numpy(), got) < tol
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < tol


def test_an_empty_slice_gives_empty_partials_that_weigh_nothing():
    """Sequences of 1 and 5 tokens in pages of 16 split 4 ways: slices 1-3
    of the first, 2-3 of the second hold no live token: their partials are
    (zeros, (-inf, 0)), and poison in their rows leaves the merge alone."""
    rng = np.random.RandomState(5)
    q, kp, vp, pt, lens = (torch.from_numpy(a) for a in make_case(
        rng, 2, 4, 1, 16, 16, 2, lens=[1, 5]))
    acc, ml = tops.paged_attention(q, *slice_pools(kp, vp, 4, 2), pt, lens,
                                   page_stride=16, token_offset=8)
    assert acc.shape == (2, 4, 1, 16) and ml.shape == (2, 4, 1, 2)
    assert not acc.any() and (ml[..., 0] == float("-inf")).all()
    assert not ml[..., 1].any()
    base = sliced(q, kp, vp, pt, lens, 4)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[:, :, 5:], vp2[:, :, 5:] = 1e3, -1e3      # rows past every length
    assert torch.equal(sliced(q, kp2, vp2, pt, lens, 4), base)


def test_slice_mode_on_meta_tensors_gives_shapes_only():
    """The planning tools' dry run: meta tensors in, partials' and the
    merge's shapes out, nothing launched."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    n0 = paged_attn.paged_attention.launches
    acc, ml = tops.paged_attention(
        meta(4, 8, 32), meta(6, 2, 8, 32), meta(6, 2, 8, 32),
        meta(4, 3, dtype=torch.int32), meta(4, dtype=torch.int32),
        page_stride=16, token_offset=8)
    assert acc.device.type == "meta" and acc.shape == (4, 8, 1, 32)
    assert ml.shape == (4, 8, 1, 2)
    out = tops.merge_partials(acc, ml, torch.bfloat16)
    assert out.shape == (4, 8, 32) and out.dtype == torch.bfloat16
    assert paged_attn.paged_attention.launches == n0


def test_slice_split_count_at_serving_sizes():
    """A slice launch's split count fills one wave of the slice
    instantiation's three blocks per SM: at Yi-6B's B 32 decode shape (128
    sequence-heads, 132 pages, 132 SMs) 3 splits, where the whole-page
    launch's two blocks per SM give 2; at the launcher's batch of 4, 22
    against 15."""
    assert _cuda.paged_attn_splits(128, 132, 132, 3) == 3
    assert _cuda.paged_attn_splits(128, 132, 132, 2) == 2
    assert _cuda.paged_attn_splits(16, 132, 132, 3) == 22
    assert _cuda.paged_attn_splits(16, 132, 132, 2) == 15


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("PS", [8, 16])
def test_stretched_lengths_make_whole_pages_one_slice(jdt, tdt, tol, PS):
    """``tools/attention_modes.py`` times whole pages through the slice
    mode as slice 0 of pages of 2 * PS tokens, each length L stretched to
    (L // PS) * 2 * PS + L % PS: the same rows are live, so the plain
    slice mode's merged partials equal the whole-page plain version's one
    slice bit for bit, and the JAX package's plain version within the
    dtype's tolerance."""
    MAXP = 5
    lens = [1, PS, PS + 3, 2 * PS - 1, MAXP * PS]
    rng = np.random.RandomState(PS)
    (jq, jk, jv, jpt, jl), targs = both(
        make_case(rng, len(lens), 8, 2, 32, PS, MAXP, lens=lens), jdt, tdt)
    q, kp, vp, pt, ln = targs
    acc, ml = tops.paged_attention(q, kp, vp, pt, ln // PS * 2 * PS + ln % PS,
                                   page_stride=2 * PS, token_offset=0)
    got = tops.merge_partials(acc, ml, tdt)
    assert torch.equal(got, sliced(*targs, 1))
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < tol


def test_a_variant_builds_apart_from_the_port():
    """A source built with extra definitions (the stamped attention
    kernel) goes into a directory of its own, keyed by its flags; the
    library the port loads is built with none."""
    port = _cuda._target("paged_attn.cu")
    stamped = _cuda._target(*_cuda.ATTN_STAMPS)
    assert port.parent == _cuda.BUILD_DIR
    assert stamped.parent == _cuda.BUILD_DIR / "variant_PAGED_ATTN_STAMPS"
    assert stamped.name.startswith("paged_attn-") and stamped.name != port.name


def test_breakdown_summary_of_synthetic_stamps():
    """``tools/attention_breakdown.py``'s summary of per-block stamps: two
    blocks 2 us apart, each 1 us of setup, 0.5 to its first tile, 8 in its
    loop and 2 in the merge (0.5 into shared memory), its warps' loops
    ending over 0.5 us, at 2 cycles per ns."""
    spec = importlib.util.spec_from_file_location(
        "attention_breakdown", ROOT / "tools" / "attention_breakdown.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    points = 10
    at = [0, 1000, 1500, 9500, 11500, 10000, 9000, 9200, 9400, 9500]
    st = np.zeros((2, 2 * points + 2), np.int64)
    for blk, start in enumerate((10_000, 12_000)):
        st[blk, 0:2 * points:2] = [start + t for t in at]
        st[blk, 1:2 * points:2] = [2 * (start + t) + 7 for t in at]
        st[blk, 2 * points], st[blk, 2 * points + 1] = blk, 5
    got = ab._summarise(st, points)
    assert got["phases_us"] == {"setup": 1.0, "first_tile": 0.5, "loop": 8.0,
                                "merge": 2.0, "merge_smem": 0.5,
                                "merge_out": 1.5}
    assert got["span_us"] == 13.5 and got["cycles_per_ns"] == 2.0
    assert got["starts_us"] == [0.0, 2.0, 2.0]
    assert got["ends_us"] == [11.5, 13.5, 13.5]
    assert got["warp_skew_us"] == 0.5 and got["tiles"] == [5, 5]
    assert got["blocks"] == 2 and got["sms"] == 2 and got["empty_blocks"] == 0


def split_slice_partials(q, kp, vp, pt, lens, m, r, splits):
    """Slice ``r`` of ``m``'s partials per split of the page range, as the
    kernel's slice mode writes them: the plain slice mode over each
    split's pages (the others unmapped), in split order."""
    PS = kp.shape[2]
    parts = []
    for b, e in _cuda.split_pages(pt.shape[1], splits):
        cut = torch.full_like(pt, -1)
        cut[:, b:e] = pt[:, b:e]
        parts.append(tops.paged_attention(q, *slice_pools(kp, vp, m, r), cut,
                                          lens, page_stride=PS,
                                          token_offset=r * (PS // m)))
    return (torch.cat([a for a, _ in parts], 2),
            torch.cat([b for _, b in parts], 2))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("m", [2, 4])
def test_slice_split_counts_merge_to_the_plain_version(jdt, tdt, tol, m):
    """Each slice cut into the split count of one wave of slice blocks (16
    SMs, three blocks each, 8 sequence-heads of 20 pages of 16: 5 splits),
    every slice's splits' partials merged in slice then split order
    (``transformer._merge_slices``' order): within the dtype's tolerance
    (float32 2e-5, bf16 6e-2) of the unsliced plain version and of the
    JAX package's."""
    PS, MAXP = 16, 20
    lens = [1, PS // m, 3 * PS + 1, MAXP * PS]
    rng = np.random.RandomState(40 + m)
    (jq, jk, jv, jpt, jl), targs = both(
        make_case(rng, len(lens), 8, 2, 32, PS, MAXP, lens=lens), jdt, tdt)
    splits = _cuda.paged_attn_splits(len(lens) * 2, MAXP, 16, 3)
    assert splits == 5
    parts = [split_slice_partials(*targs, m, r, splits) for r in range(m)]
    got = tops.merge_partials(torch.cat([a for a, _ in parts], 2),
                              torch.cat([b for _, b in parts], 2), tdt)
    assert got.shape == targs[0].shape and got.dtype == tdt
    assert err(tops.paged_attention(*targs).float().numpy(), got) < tol
    assert err(jax_ref(jq, jk, jv, jpt, jl), got) < tol
