"""Transformer building blocks: norms, RoPE, blockwise attention, MLP.

Port of ``repro.models.layers`` (dense family).  Functions are pure and
parameters plain dicts of tensors; every function computes in the same
dtypes as the reference (norms, RoPE and attention scores in float32, the
residual stream in the model's dtype).  Attention is blockwise over query
chunks: each chunk sees the whole key range under the causal mask, which
bounds the score tensor at (chunk x S) per layer.  Not ported yet: the
sliding-window band, the ``causal_skip`` inner loop and ``moe``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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

def rope(x, positions, theta=10000.0):
    """x: (..., S, H, D) or (..., H, D) with positions (..., S) / (...,)."""
    D = x.shape[-1]
    half = D // 2
    freq = torch.from_numpy(1.0 / (theta ** (np.arange(0, half) / half))).to(
        device=x.device, dtype=F32)
    ang = positions[..., None].to(F32) * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise causal attention (GQA)
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, chunk: int, window: int = 0,
                        q_offset=0, causal_skip: bool = False):
    """Causal attention, looped over q chunks (the reference's masked mode).

    q: (B, S, H, D); k, v: (B, T, KVH, D); returns (B, S, H, D).
    ``q_offset``: absolute position of q[0] (for prefill continuation).
    """
    if window > 0 or causal_skip:
        raise NotImplementedError(
            "sliding-window and causal_skip attention are not ported yet "
            "(ROADMAP.md, Queue 1 #11)")
    B, S_in, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / (D ** 0.5)
    C = min(chunk, S_in)
    if S_in % C:                       # pad q chunks; outputs sliced below
        q = F.pad(q, (0, 0, 0, 0, 0, C - S_in % C))
    nC = q.shape[1] // C
    qg = q.reshape(B, nC, C, KVH, G, D)
    kf, vf = k.to(F32), v.to(F32)
    kpos = torch.arange(T, device=q.device)
    outs = []
    for c in range(nC):
        s = torch.einsum("bckgd,btkd->bkgct", qg[:, c].to(F32), kf) * scale
        qpos = c * C + q_offset + torch.arange(C, device=q.device)
        live = kpos[None, :] <= qpos[:, None]
        s = s.masked_fill(~live, float("-inf"))
        outs.append(torch.einsum("bkgct,btkd->bckgd", torch.softmax(s, -1),
                                 vf))
    out = torch.stack(outs, 1)                          # (B,nC,C,KVH,G,D)
    return out.reshape(B, nC * C, H, D)[:, :S_in].to(q.dtype)


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
