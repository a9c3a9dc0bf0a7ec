"""The port's paged attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), the JAX plain version, and the port's
``ops.paged_attention`` — whose wrapper runs its plain version on a CPU
tensor.  Tolerances are those of ``tests/test_kernels.py``: float32 2e-5,
bfloat16 6e-2.  The CUDA kernel itself is held against the port's plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged_attn_ref import paged_attention_ref as jax_ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attn

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
