"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

Port of ``repro.models.ssm``.  The forward pass is the chunked SSD
algorithm: within a chunk the recurrence is a masked, attention-like
matrix (the "duality"), and chunks are linked by a loop over the running
state, so the cost is O(S·chunk·(d_state + head_dim)), sub-quadratic in S.
Decode is the O(1)-per-token recurrence with a rolling conv window.  Both
compute in the reference's dtypes: projections and the conv in the
model's dtype, the scan, the gate and the norm in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import shard

F32 = torch.float32


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.d_state
    return d_inner, nheads, conv_ch


def init_ssm_params(gen: torch.Generator, cfg, scale=0.02) -> dict:
    """One layer's SSM parameters, float32, drawn from ``gen`` on its
    device, with the reference's distributions (its values come across
    through ``convert.params_from_numpy``)."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    E = cfg.d_model
    dev = gen.device
    proj_out = 2 * d_inner + 2 * s.d_state + nheads

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=F32) * scale
    # Mamba-2 dt init: dt ~ LogUniform(1e-3, 1e-1) through the softplus
    # inverse as a bias: slow decay gives the state long memory from step 0
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(torch.rand(nheads, generator=gen, device=dev, dtype=F32)
                    * (hi - lo) + lo)
    return {
        "in_proj": normal(E, proj_out),
        "conv_w": normal(s.conv_width, conv_ch),
        "conv_b": torch.zeros(conv_ch, dtype=F32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=F32,
                                          device=dev)),
        "D": torch.ones(nheads, dtype=F32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "ssm_norm": torch.ones(d_inner, dtype=F32, device=dev),
        "out_proj": normal(d_inner, E),
    }


def _split_proj(cfg, proj):
    """(..., proj_out) -> z, x, B, C, dt."""
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    return torch.split(proj, [d_inner, d_inner, s.d_state, s.d_state,
                              nheads], dim=-1)


def _causal_conv(xcbc, w, b):
    """Depthwise causal conv over (B, S, CH) with kernel (W, CH), in the
    input's dtype (a sum of shifted products, as the reference's)."""
    W, S = w.shape[0], xcbc.shape[1]
    pad = F.pad(xcbc, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + S] * w[i][None, None]
    return out + b


def _gated_norm(y, z, p):
    """y * silu(z), then the RMSNorm (eps 1e-6) before the out-projection
    (Mamba-2's block layout); float32."""
    y = y * F.silu(z.to(F32))
    var = y.square().mean(-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * p["ssm_norm"]


def ssd_forward(cfg, p, x, apply_out: bool = True):
    """x: (B, S, E) -> (B, S, E), or (B, S, d_inner) without the
    out-projection when ``apply_out`` is False (hybrids fuse heads before
    a shared projection).  Chunked SSD with a state loop across chunks."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    B_, S_in, E = x.shape
    P, N, Q = s.head_dim, s.d_state, min(s.chunk, S_in)
    if S_in % Q:                       # zero-pad tail to a chunk multiple
        x = F.pad(x, (0, 0, 0, Q - S_in % Q))
    S = x.shape[1]
    nQ = S // Q
    dt_ = x.dtype

    proj = x @ p["in_proj"].to(dt_)
    z, xc, Bm, Cm, dtr = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, Bm, Cm], -1)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"].to(dt_),
                               p["conv_b"].to(dt_)).to(F32))
    xc, Bm, Cm = (conv[..., :d_inner], conv[..., d_inner:d_inner + N],
                  conv[..., d_inner + N:])
    xh = xc.reshape(B_, S, nheads, P)                        # (B,S,H,P)
    dt = F.softplus(dtr.to(F32) + p["dt_bias"].to(F32))      # (B,S,H)
    A = -torch.exp(p["A_log"].to(F32))                       # (H,) negative
    la = dt * A[None, None]                                  # log decay

    # chunked views
    cum = torch.cumsum(la.reshape(B_, nQ, Q, nheads), dim=2)  # (B,nQ,Q,H)
    xq = xh.reshape(B_, nQ, Q, nheads, P)
    dtq = dt.reshape(B_, nQ, Q, nheads)
    Bq = Bm.reshape(B_, nQ, Q, N).to(F32)
    Cq = Cm.reshape(B_, nQ, Q, N).to(F32)

    # intra-chunk (the duality's masked attention-like term).  Masked
    # BEFORE exp: the entries above the diagonal have positive log-decays
    # whose exp overflows (and whose gradient would be 0 * inf)
    CB = torch.einsum("bqtn,bqsn->bqts", Cq, Bq)             # (B,nQ,Q,Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # l_t - l_s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    seg = torch.where(tri[None, None, :, :, None], seg, -1e30)
    G = torch.exp(seg) * CB[..., None] * dtq[:, :, None, :, :]
    y_intra = torch.einsum("bqtsh,bqshp->bqthp", G, xq)

    # inter-chunk state loop (emits each chunk's PRE-state)
    decay_out = torch.exp(cum)                                # exp(l_t)
    decay_in = torch.exp(cum[:, :, -1:, :] - cum)             # exp(l_Q - l_s)
    dBx = torch.einsum("bqsh,bqsn,bqshp->bqhnp", dtq * decay_in, Bq, xq)
    chunk_decay = torch.exp(cum[:, :, -1])                    # (B,nQ,H)
    state = torch.zeros((B_, nheads, N, P), dtype=F32, device=x.device)
    pre = []
    for q in range(nQ):
        pre.append(state)
        state = state * chunk_decay[:, q, :, None, None] + dBx[:, q]
    pre = torch.stack(pre, 1)                                 # (B,nQ,H,N,P)
    y_inter = torch.einsum("bqtn,bqth,bqhnp->bqthp", Cq, decay_out, pre)

    y = (y_intra + y_inter).reshape(B_, S, nheads, P)
    y = y + xh * p["D"].to(F32)[None, None, :, None]
    y = _gated_norm(y.reshape(B_, S, d_inner), z, p)
    y = y[:, :S_in]                    # drop chunk padding
    if not apply_out:
        return y.to(dt_)
    return y.to(dt_) @ p["out_proj"].to(dt_)


def init_ssm_state(cfg, batch, dtype=F32, device="cuda") -> dict:
    """One layer's zero state on ``device``: ``S`` float32, ``conv`` in
    ``dtype``."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    return {
        "S": torch.zeros((batch, nheads, s.d_state, s.head_dim), dtype=F32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssd_decode(cfg, p, x, state, apply_out: bool = True):
    """One-token recurrent step.  x: (B, E); state {"S", "conv"}; returns
    (y (B, E), or (B, d_inner) without ``apply_out``, new state)."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    B_ = x.shape[0]
    N, P = s.d_state, s.head_dim
    dt_ = x.dtype

    proj = x @ p["in_proj"].to(dt_)
    z, xc, Bm, Cm, dtr = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, Bm, Cm], -1)                     # (B, CH)
    # the window in the promoted dtype of the state and x, as the
    # reference's concatenate (a float32 state cache keeps it float32)
    ct = torch.promote_types(state["conv"].dtype, dt_)
    hist = torch.cat([state["conv"].to(ct), conv_in[:, None].to(ct)], 1)
    w = p["conv_w"].to(dt_).to(ct)
    conv = F.silu((torch.einsum("bwc,wc->bc", hist, w)
                   + p["conv_b"].to(dt_)).to(F32))
    xc, Bv, Cv = (conv[:, :d_inner], conv[:, d_inner:d_inner + N],
                  conv[:, d_inner + N:])
    xhp = xc.reshape(B_, nheads, P)
    dt = F.softplus(dtr.to(F32) + p["dt_bias"].to(F32))       # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"].to(F32)))        # (B,H)
    S_new = shard(state["S"] * a[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, Bv, xhp), "batch", "ssm_heads", None, None)
    y = torch.einsum("bn,bhnp->bhp", Cv, S_new)
    y = y + xhp * p["D"].to(F32)[None, :, None]
    y = _gated_norm(y.reshape(B_, d_inner), z, p)
    new_state = {"S": S_new, "conv": hist[:, 1:]}
    if not apply_out:
        return y.to(dt_), new_state
    return y.to(dt_) @ p["out_proj"].to(dt_), new_state
