"""Plain reference of a Llama-architecture decoder (Yi-6B), in float32.

Plain PyTorch over the weights the benchmark made; it imports nothing of
the program.  The layer equations are the published architecture's:
RMSNorm before attention and before the MLP, rotary position embedding
in the half-rotation layout at ``rope_theta``, grouped-query causal
attention (query head h reads key/value head h // (heads / kv heads)),
the SwiGLU MLP, a final RMSNorm and the untied output head.  Every
product runs in float32 with TF32 off; layers run one at a time with
their weights widened to float32 on the way.

``quant="fp8"`` is the control: every matmul's operands rounded to
float8 e4m3 (per output channel for weights, per row for activations)
before the float32 product, the precision below the served bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the reduction dimension of its product)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


def _mm(a, w, quant):
    w = w.to(F32)
    if quant == "fp8":
        return fp8(a, -1) @ fp8(w, 0)
    return a @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope_tables(T: int, D: int, theta: float, device):
    half = D // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                         device=device) / half))
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freq
    return torch.cos(ang).to(F32), torch.sin(ang).to(F32)


def rope(x, cos, sin):
    """x (B, T, n, D): rotate the halves [0, D/2) and [D/2, D)."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(q, k, v):
    """Causal GQA: q (B, T, H, D), k and v (B, T, KVH, D) -> (B, T, H*D)."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(B, T, H, D, dtype=F32, device=q.device)
    for b in range(B):
        qb = q[b].transpose(0, 1)                               # (H, T, D)
        kb = k[b].transpose(0, 1).repeat_interleave(G, 0)
        vb = v[b].transpose(0, 1).repeat_interleave(G, 0)
        s = (qb @ kb.transpose(1, 2)) * D ** -0.5
        s = s.masked_fill(~mask, float("-inf"))
        out[b] = (torch.softmax(s, -1) @ vb).transpose(0, 1)
    return out.reshape(B, T, H * D)


def logits(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
           quant=None) -> torch.Tensor:
    """Float32 logits (B, T - first, V) of the positions [first, T) of
    ``tokens`` (B, T), each predicting the token after it.  ``w`` holds
    the weights as the benchmark made them: ``embed`` (V, E),
    ``lm_head`` (E, V), ``final_scale`` (E,), and per layer (stacked on a
    leading layer dim) ``ln1_scale``, ``ln2_scale``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``, each stored
    (in, out)."""
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E = cfg["hidden_size"]
    D, eps = E // H, cfg["rms_norm_eps"]
    B, T = tokens.shape
    blk = w["blocks"]
    with no_tf32():
        cos, sin = rope_tables(T, D, cfg["rope_theta"], tokens.device)
        x = w["embed"][tokens.long()].to(F32)
        for i in range(cfg["num_hidden_layers"]):
            h = rmsnorm(x, blk["ln1_scale"][i], eps)
            q = _mm(h, blk["wq"][i], quant).reshape(B, T, H, D)
            k = _mm(h, blk["wk"][i], quant).reshape(B, T, KVH, D)
            v = _mm(h, blk["wv"][i], quant).reshape(B, T, KVH, D)
            a = attention(rope(q, cos, sin), rope(k, cos, sin), v)
            x = x + _mm(a, blk["wo"][i], quant)
            del q, k, v, a
            h = rmsnorm(x, blk["ln2_scale"][i], eps)
            g = _mm(h, blk["w_gate"][i], quant)
            u = _mm(h, blk["w_up"][i], quant)
            x = x + _mm(torch.nn.functional.silu(g) * u, blk["w_down"][i],
                        quant)
            del g, u, h
        x = rmsnorm(x[:, first:], w["final_scale"], eps)
        return _mm(x, w["lm_head"], quant)


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor):
    """Per position, how far the served token's logit lies below the
    reference's best: (B, n)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, served.long()[..., None])[..., 0]
