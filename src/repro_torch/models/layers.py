"""Transformer building blocks: norms, RoPE, blockwise attention, MLP, MoE.

Port of ``repro.models.layers``.  Functions are pure and
parameters plain dicts of tensors; every function computes in the same
dtypes as the reference (norms, RoPE and attention scores in float32, the
residual stream in the model's dtype).  Attention is blockwise over query
chunks: each chunk sees the whole key range under the causal mask, which
bounds the score tensor at (chunk x S) per layer; sliding-window
attention uses a banded slice of width (window + chunk), so its FLOPs are
O(S · window).  ``moe`` is the top-k expert layer (capacity-bucket or
dense dispatch); its expert products are plain matmuls, as the
reference's are plain einsums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distribution import sharding as SH

F32 = torch.float32


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.to(F32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)
    return y.to(x.dtype)


def apply_norm(cfg, p, prefix, x):
    if cfg.norm == "rms":
        return rmsnorm(x, p[f"{prefix}_scale"])
    return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])


# ---------------------------------------------------------------------------
# rotary position embedding (GPT-NeoX half-rotation convention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device):
    """The rotation frequencies (half,) float32 on ``device``, computed in
    float64 on the host once (a host-to-device copy per call would stall
    every decode layer on the card)."""
    return torch.from_numpy(1.0 / (theta ** (np.arange(0, half) / half))).to(
        device=device, dtype=F32)


def rope(x, positions, theta=10000.0):
    """x: (..., S, H, D) or (..., H, D) with positions (..., S) / (...,)."""
    D = x.shape[-1]
    half = D // 2
    freq = _rope_freq(half, theta, x.device)
    ang = positions[..., None].to(F32) * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise causal attention (GQA)
# ---------------------------------------------------------------------------

def _attn_scores(q, k, scale):
    """q (B,C,KVH,G,D) x k (B,T,KVH,D) -> (B,KVH,G,C,T) f32."""
    return torch.einsum("bckgd,btkd->bkgct", q.to(F32), k.to(F32)) * scale


def _attn_out(p, v):
    """p (B,KVH,G,C,T) x v (B,T,KVH,D) -> (B,C,KVH,G,D)."""
    return torch.einsum("bkgct,btkd->bckgd", p, v.to(F32))


def blockwise_attention(q, k, v, *, chunk: int, window: int = 0,
                        q_offset=0, causal_skip: bool = False):
    """Causal (optionally sliding-window) attention, looped over q chunks.

    q: (B, S, H, D); k, v: (B, T, KVH, D); returns (B, S, H, D).
    ``q_offset``: absolute position of q[0] (for prefill continuation).
    ``window > 0`` restricts attention to the last ``window`` positions
    over a banded slice of ``window + chunk`` keys (FLOPs O(S·window)).
    ``causal_skip``: an inner loop over KV chunks with an online softmax,
    skipping the chunk pairs above the diagonal (the reference's
    ``lax.cond``); the masked mode sees every key under the causal mask.
    """
    if SH.is_dtensor(q):
        return _blockwise_local(q, k, v, chunk=chunk, window=window,
                                q_offset=q_offset, causal_skip=causal_skip)
    B, S_in, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    C = min(chunk, S_in)
    if S_in % C:                       # pad q chunks; outputs sliced below
        q = F.pad(q, (0, 0, 0, 0, 0, C - S_in % C))
    nC = q.shape[1] // C
    qg = q.reshape(B, nC, C, KVH, G, D)
    dev = q.device
    ar = torch.arange(C, device=dev)

    if window > 0:
        band = min(window + C, T)      # static banded width

        def step(c):
            # the reference's clamped start: a start that differs at the
            # sequence's edges changes which keys are live
            start = max(c * C + q_offset - window, 0)
            start = min(start, max(T - (window + C), 0))
            kb, vb = k[:, start:start + band], v[:, start:start + band]
            s = _attn_scores(qg[:, c], kb, scale)        # (B,KVH,G,C,band)
            qpos = c * C + q_offset + ar
            kpos = start + torch.arange(band, device=dev)
            live = (kpos[None, :] <= qpos[:, None]) & \
                (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~live, float("-inf"))
            return _attn_out(torch.softmax(s, -1), vb)
    elif causal_skip:
        if T % C:                      # pad kv to a chunk multiple (masked)
            k = F.pad(k, (0, 0, 0, 0, 0, C - T % C))
            v = F.pad(v, (0, 0, 0, 0, 0, C - T % C))
            T = k.shape[1]
        nK = T // C

        def step(c):
            qc = qg[:, c]
            qpos = c * C + q_offset + ar
            m_r = torch.full((B, KVH, G, C), -1e30, dtype=F32, device=dev)
            l_r = torch.zeros((B, KVH, G, C), dtype=F32, device=dev)
            acc = torch.zeros((B, KVH, G, C, D), dtype=F32, device=dev)
            for j in range(min(c + 1, nK)):     # chunk pairs j <= c only
                kj, vj = k[:, j * C:(j + 1) * C], v[:, j * C:(j + 1) * C]
                s = _attn_scores(qc, kj, scale)          # (B,KVH,G,C,C)
                kpos = j * C + ar
                s = torch.where(kpos[None, :] <= qpos[:, None], s, -1e30)
                m_new = torch.maximum(m_r, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m_r - m_new)
                l_r = l_r * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgct,btkd->bkgcd", p, vj.to(F32))
                m_r = m_new
            out = acc / torch.clamp(l_r, min=1e-30)[..., None]
            return out.movedim(3, 1)                     # (B,C,KVH,G,D)
    else:
        kpos = torch.arange(T, device=dev)

        def step(c):
            s = _attn_scores(qg[:, c], k, scale)         # (B,KVH,G,C,T)
            qpos = c * C + q_offset + ar
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]),
                              float("-inf"))
            return _attn_out(torch.softmax(s, -1), v)

    out = torch.stack([step(c) for c in range(nC)], 1)  # (B,nC,C,KVH,G,D)
    return out.reshape(B, nC * C, H, D)[:, :S_in].to(q.dtype)


def _blockwise_local(q, k, v, **kw):
    """``blockwise_attention`` under a mesh.  Attention is independent per
    sequence and per group of heads sharing a kv head, so q, k and v are
    placed alike, sharded at most on the batch and head dims (q's heads
    as k's kv heads: each group whole on a rank), and every rank attends
    over its own shard on plain tensors.  DTensor's own rules for the
    loop's views and einsums differ between torch releases (some refuse a
    sharded kv-head dim); autograd flows through both conversions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in k.placements)
    q, k, v = (SH.to_placements(t, mesh, pl) for t in (q, k, v))
    out = blockwise_attention(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=q.shape, stride=q.stride())


def decode_attention(q, k, v, seq_len, *, window: int = 0):
    """Single-token attention against a (B, T, KVH, D) cache (T = ring or
    linear buffer). q: (B, H, D). ``seq_len`` (B,) live lengths."""
    B, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(F32), k.to(F32)) * scale
    idx = torch.arange(T, device=q.device)[None]
    live = idx < torch.clamp(seq_len, max=T if window == 0 else window)[:, None]
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    out = torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, -1), v.to(F32))
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, kg, vg, page_table, seq_lens, page_size: int):
    """Decode attention over gathered pages with (MAXP, PS) kept separate.

    q: (DS, Bl, H, D); kg/vg: (DS, Bl, MAXP, KVH, PS, D);
    page_table: (DS, Bl, MAXP) (-1 = unmapped); seq_lens: (DS, Bl) live
    lengths INCLUDING the just-written token. Returns (DS, Bl, H, D).
    """
    DS, Bl, H, D = q.shape
    KVH, PS = kg.shape[3], kg.shape[4]
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(DS, Bl, KVH, G, D).to(F32)
    s = torch.einsum("sbkgd,sbmkpd->sbkgmp", qg, kg.to(F32)) * scale
    dev = q.device
    tok = (torch.arange(kg.shape[2], device=dev)[:, None] * page_size
           + torch.arange(PS, device=dev)[None, :])      # (MAXP, PS)
    live = ((tok[None, None] < seq_lens[..., None, None])
            & (page_table[..., None] >= 0))              # (DS,Bl,MAXP,PS)
    s = torch.where(live[:, :, None, None], s, -1e30)
    m = s.amax(dim=(-2, -1), keepdim=True)
    pr = torch.exp(s - m)
    pr = pr / torch.clamp(pr.sum(dim=(-2, -1), keepdim=True), min=1e-30)
    out = torch.einsum("sbkgmp,sbmkpd->sbkgd", pr, vg.to(F32))
    return out.reshape(DS, Bl, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x):
    dt = x.dtype
    if cfg.mlp == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        h = F.silu(g.to(F32)).to(dt) * u
    else:
        h = x @ p["w_up"].to(dt)
        h = F.gelu(h.to(F32), approximate="tanh").to(dt)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, sort-based dispatch, capacity-bounded)
# ---------------------------------------------------------------------------

def _dense_moe_group(num_experts: int) -> int:
    """Expert-group size for the dense MoE loop (bounds transients)."""
    for g in (8, 5, 4, 2, 1):
        if num_experts % g == 0:
            return g
    return 1


def moe_route(cfg, p, xt):
    """Router of ``moe``: xt (T, E) -> (float32 logits (T, NE), top-k
    expert ids (T, K) in descending logit order, renormalised gates
    (T, K)).  The router is read in float32 whatever the model's dtype:
    a bf16 router flips top-k choices."""
    logits = xt.to(F32) @ p["router"].to(F32)
    topv, topi = torch.topk(logits, cfg.moe.top_k, dim=-1, sorted=True)
    return logits, topi, torch.softmax(topv, -1)


def moe_dispatch(cfg, topi, gates):
    """Capacity-bucket plan of the sorted dispatch: the (token, expert)
    assignments sorted stably by expert as (expert, token, gate), each
    one's rank within its expert, the keep mask (rank < capacity) and the
    capacity, ``ceil(T·K / NE · capacity_factor)``."""
    m = cfg.moe
    T, K = topi.shape
    dev = topi.device
    eid = topi.reshape(T * K)
    order = torch.argsort(eid, stable=True)
    se = eid[order]
    st = torch.arange(T, device=dev).repeat_interleave(K)[order]
    sg = gates.reshape(T * K)[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * K, device=dev) - first        # rank within expert
    cap = int(np.ceil(T * K / m.num_experts * m.capacity_factor))
    return se, st, sg, pos, pos < cap, cap


def _moe_aux(cfg, logits, topi):
    """Switch-style load-balance loss, returned for training."""
    m = cfg.moe
    me = torch.softmax(logits, -1).mean(0)
    ids = topi.reshape(-1)
    ce = torch.zeros(m.num_experts, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids)).to(F32) / topi.numel()
    return m.num_experts * (me * ce).sum()


def moe(cfg, p, x):
    """x: (B, S, E) -> ((B, S, E), aux).  Two implementations:

    "sorted": capacity-bucket dispatch (stable sort by expert, a scatter
    into (NE, cap, E) buckets, the expert products, a gather back):
    assignments ranked at or past an expert's capacity are dropped.

    "dense": every expert on every token, weighted by the (masked,
    renormalised top-k) gates; no token is dropped.  Expert groups are
    looped to bound the (T, NE_g, dff) transient.
    """
    if SH.is_dtensor(x):
        return _moe_gathered(cfg, p, x)
    m = cfg.moe
    B, S, E = x.shape
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, E)
    logits, topi, gates = moe_route(cfg, p, xt)

    if m.impl == "dense":
        gate_full = torch.zeros((T, m.num_experts), dtype=F32,
                                device=x.device).scatter(1, topi, gates)
        GE = _dense_moe_group(m.num_experts)
        out = torch.zeros((T, E), dtype=F32, device=x.device)
        for i in range(0, m.num_experts, GE):
            wg, wu, wd = (p[n][i:i + GE].to(dt)
                          for n in ("we_gate", "we_up", "we_down"))
            g = torch.einsum("td,xdf->txf", xt, wg)
            u = torch.einsum("td,xdf->txf", xt, wu)
            h = F.silu(g.to(F32)).to(dt) * u
            y = torch.einsum("txf,xfd->txd", h, wd)
            out = out + torch.einsum("txd,tx->td", y.to(F32),
                                     gate_full[:, i:i + GE])
        return out.reshape(B, S, E).to(dt), _moe_aux(cfg, logits, topi)

    se, st, sg, pos, keep, cap = moe_dispatch(cfg, topi, gates)
    # assignments past capacity go nowhere (the reference scatters them
    # into an out-of-range expert row with mode="drop")
    buf = torch.zeros((m.num_experts, cap, E), dtype=dt, device=x.device)
    buf[se[keep], pos[keep]] = xt[st[keep]]
    g = torch.einsum("xcd,xdf->xcf", buf, p["we_gate"].to(dt))
    u = torch.einsum("xcd,xdf->xcf", buf, p["we_up"].to(dt))
    h = F.silu(g.to(F32)).to(dt) * u
    y = torch.einsum("xcf,xfd->xcd", h, p["we_down"].to(dt))
    contrib = y[se, torch.clamp(pos, max=cap - 1)].to(F32) \
        * (sg * keep)[:, None]
    return (_moe_combine(contrib, st, T).reshape(B, S, E).to(dt),
            _moe_aux(cfg, logits, topi))


def _moe_gathered(cfg, p, x):
    """``moe`` under a mesh.  Its dispatch (argsort, searchsorted, masked
    scatters) has no DTensor sharding rules, so the tokens and the router
    and expert weights are replicated and every rank runs the layer on
    plain local tensors; the results come back as replicated DTensors
    (autograd flows through both conversions)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def local(t):
        return t.redistribute(mesh, rep).to_local() if SH.is_dtensor(t) else t
    lp = {k: local(p[k]) for k in ("router", "we_gate", "we_up", "we_down")}
    out, aux = moe(cfg, lp, local(x))
    return (DTensor.from_local(out, mesh, rep, run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))


def _moe_combine(contrib, st, T):
    """Each token's sum of its K contributions (``contrib``: (T·K, E) in
    the dispatch's sorted order, ``st`` their tokens), added into float32
    zeros one slot at a time in that order, which visits a token's experts
    in ascending id: the order the reference's ``out.at[st].add`` takes on
    the CPU.  Plain gathers, no atomics: the same bits on every run."""
    # each token's K sorted positions, ascending (st holds each token K times)
    slots = torch.argsort(st, stable=True).view(T, -1)
    out = torch.zeros((T, contrib.shape[1]), dtype=F32, device=contrib.device)
    for k in range(slots.shape[1]):
        out = out + contrib[slots[:, k]]
    return out
