"""Analytic per-cell FLOPs / HBM-traffic model for the roofline.

Port of ``repro.launch.analytic``, the same arithmetic on the same
``ModelConfig`` / ``ShapeConfig`` fields, so every ``CellModel`` field is
the reference's float.  ``launch.dryrun`` records it beside the
collectives it counts: the reference's XLA cost analysis counts a
``while`` body once, and the port's dry run has no cost analysis at all,
so this transparent model is the compute and memory input of the
roofline.

Conventions:
  * matmul FLOPs = 2·M·N·K; backward = 2x forward; remat="full" recomputes
    the forward once more (+1x);
  * attention is counted as IMPLEMENTED: the blockwise-masked causal path
    computes the full S x T score matrix (2x the useful causal half) — the
    gap is visible as useful/computed and is a hillclimb target;
  * HBM traffic is a floor model: weights + optimizer streams, activation
    reads/writes per layer at 2 B, K/V re-reads once per query chunk
    (the blockwise loop re-streams K/V), KV-pool reads at decode;
  * per-device = global / (dp·tp) for sharded dims, with replication where
    the config's dims don't divide the mesh (mirrors logical_spec).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


def _div(n: int, shards: int) -> float:
    """Shard a dim if divisible, else replicated (matches logical_spec)."""
    return n / shards if n % shards == 0 else n


@dataclasses.dataclass
class CellModel:
    flops_total: float          # computed FLOPs, whole step, all devices
    flops_useful: float         # model FLOPs (6/2·N_active·D convention)
    hbm_bytes_dev: float        # HBM traffic per device
    notes: str = ""


def _attn_flops(cfg, B, S, T, causal_full_matrix=True):
    """q·k^T + p·v for all layers; counts the masked full matrix when the
    implementation computes it (blockwise "masked" path) and the causal half
    (+ diagonal chunk) under "causal_skip"."""
    H, D = cfg.n_heads, cfg.hd
    if not cfg.has_attention:
        return 0.0
    nC = max(S // max(cfg.attn_chunk, 1), 1)
    causal_factor = (nC + 1) / (2.0 * nC) \
        if cfg.attn_mode == "causal_skip" else 1.0
    if cfg.family == "hybrid":
        glob_layers = 3
        win_layers = cfg.n_layers - 3
        win = min(cfg.window + 512, T)              # banded slice width
        return (4.0 * B * S * win * H * D * win_layers
                + 4.0 * B * S * T * H * D * glob_layers * causal_factor)
    return 4.0 * B * S * T * H * D * cfg.n_layers * causal_factor


def _ssd_flops(cfg, B, S):
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    Q = min(s.chunk, S)
    # CB (Q²N) + G·x (Q²P per head) + state in/out (N·P per head per token)
    per_tok = 2.0 * Q * s.d_state + 2.0 * Q * s.head_dim * nheads \
        + 4.0 * s.d_state * s.head_dim * nheads
    return B * S * per_tok * cfg.n_layers


def _matmul_params(cfg) -> int:
    """Parameters participating in per-token matmuls (excludes embeddings).
    Dense-MoE computes EVERY expert per token, so its matmul params are the
    full expert set."""
    n = (cfg.param_count if (cfg.moe and cfg.moe.impl == "dense")
         else cfg.active_param_count)
    return max(n - cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2),
               0)


def _active_matmul_params(cfg) -> int:
    """Active (top-k) matmul params — the 'useful' numerator, impl-agnostic."""
    return max(cfg.active_param_count
               - cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2), 0)


def _useful_flops(cfg, toks_mm: float, toks_head: float, mult: float) -> float:
    """mult·N·D convention with the LM head counted at its true token count
    (embedding GATHERS are not matmuls and are excluded)."""
    return mult * (_active_matmul_params(cfg) * toks_mm
                   + cfg.vocab * cfg.d_model * toks_head)


def train_cell(cfg: ModelConfig, shape: ShapeConfig, chips: int, tp: int = 16):
    B, S = shape.global_batch, shape.seq_len
    dp = chips // tp
    toks = B * S
    # remat="full" recomputes the whole forward (incl. matmuls) in the
    # backward; "dots" saves matmul outputs (no matmul recompute, but the
    # saved activations still stream through HBM)
    remat_fwd = 1.0 if cfg.remat == "none" else 2.0   # activation traffic
    remat_flops = 2.0 if cfg.remat == "full" else 1.0  # matmul recompute

    mm = 2.0 * _matmul_params(cfg) * toks            # fwd matmul flops
    attn = _attn_flops(cfg, B, S, S)
    ssd = _ssd_flops(cfg, B, S)
    logits = 2.0 * cfg.d_model * cfg.padded_vocab * toks
    fwd = mm + attn + ssd + logits
    total = fwd * (1.0 + 2.0) + (fwd - logits) * (remat_flops - 1.0)
    useful = _useful_flops(cfg, toks, toks, 6.0)

    # HBM floor per device
    N_dev = _div_params(cfg, tp)
    Bd, E = B / dp, cfg.d_model
    w = N_dev * (F32 * 3 + F32 * 4)                  # fwd+bwd+grad, m/v rw
    # residual-stream widths replicate; head/mlp widths shard over TP
    if cfg.moe and cfg.moe.impl == "dense":
        dff = cfg.moe.expert_dff * cfg.moe.num_experts   # all experts stream
    else:
        dff = (cfg.moe.expert_dff * cfg.moe.top_k if cfg.moe else cfg.d_ff)
    act_width = (2 * E
                 + (2 * cfg.n_heads * cfg.hd + 2 * cfg.n_kv_heads * cfg.hd
                    + 3 * dff) / tp)
    if cfg.moe and cfg.moe.impl != "dense":
        act_width += 4 * cfg.moe.top_k * E / tp          # dispatch rw
    act = Bd * S * act_width * BF16 * cfg.n_layers * (remat_fwd + 2.0)
    kv_restream = 0.0
    if cfg.has_attention:
        nC = max(S // cfg.attn_chunk, 1)
        cf = (nC + 1) / (2.0 * nC) if cfg.attn_mode == "causal_skip" else 1.0
        kvd = _div(cfg.n_kv_heads, tp) * cfg.hd
        kv_restream = (Bd * S * kvd * BF16 * nC * cf * 2
                       * cfg.n_layers * (remat_fwd + 1.0))
    logit_traffic = Bd * S * _div(cfg.padded_vocab, tp) * F32 * 3
    hbm = w + act + kv_restream + logit_traffic
    return CellModel(total, useful, hbm,
                     notes=f"remat_fwd={remat_fwd} dp={dp} tp={tp}")


def _div_params(cfg: ModelConfig, tp: int) -> float:
    """Per-device parameter count under the TP rules (approx: matmul params
    shard; norms/ssm-scalars replicate; embeddings shard if vocab divides)."""
    mm = _matmul_params(cfg)
    emb = cfg.active_param_count - mm
    return mm / tp + _div(emb, tp)


def prefill_cell(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                 tp: int = 16):
    B, S = shape.global_batch, shape.seq_len
    dp = chips // tp
    toks = B * S
    mm = 2.0 * _matmul_params(cfg) * toks
    attn = _attn_flops(cfg, B, S, S)
    ssd = _ssd_flops(cfg, B, S)
    logits = 2.0 * cfg.d_model * cfg.padded_vocab * B   # last position only
    total = mm + attn + ssd + logits
    useful = _useful_flops(cfg, toks, B, 2.0)

    N_dev = _div_params(cfg, tp)
    Bd, E = B / dp, cfg.d_model
    dff = (cfg.moe.expert_dff * cfg.moe.top_k if cfg.moe else cfg.d_ff)
    act_width = (2 * E
                 + (2 * cfg.n_heads * cfg.hd + 2 * cfg.n_kv_heads * cfg.hd
                    + dff) / tp)
    if cfg.moe:
        act_width += 4 * cfg.moe.top_k * E / tp
    act = Bd * S * act_width * BF16 * cfg.n_layers
    kv_restream = 0.0
    if cfg.has_attention:
        nC = max(S // cfg.attn_chunk, 1)
        cf = (nC + 1) / (2.0 * nC) if cfg.attn_mode == "causal_skip" else 1.0
        kvd = _div(cfg.n_kv_heads, tp) * cfg.hd
        kv_restream = Bd * S * kvd * BF16 * nC * cf * 2 * cfg.n_layers
    pool_write = (Bd * S * cfg.n_kv_heads * cfg.hd * BF16 * 2
                  * cfg.n_layers / tp if cfg.has_attention else 0)
    hbm = N_dev * BF16 + act + kv_restream + pool_write
    return CellModel(total, useful, hbm, notes=f"dp={dp} tp={tp}")


def decode_cell(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                tp: int = 16, kv_bytes: int = BF16):
    B, T = shape.global_batch, shape.seq_len
    dp = chips // tp
    mm = 2.0 * _matmul_params(cfg) * B
    logits = 2.0 * cfg.d_model * cfg.padded_vocab * B
    ssd = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        nheads = d_inner // s.head_dim
        ssd = 4.0 * B * s.d_state * s.head_dim * nheads * cfg.n_layers
    attn = 0.0
    cache_bytes_dev = 0.0
    if cfg.has_attention:
        if cfg.family == "hybrid":
            Tw = min(cfg.window, T)
            attn = (4.0 * B * Tw * cfg.n_heads * cfg.hd * (cfg.n_layers - 3)
                    + 4.0 * B * T * cfg.n_heads * cfg.hd * 3)
            cache = (B * Tw * cfg.n_kv_heads * cfg.hd * 2 * BF16
                     * (cfg.n_layers - 3)
                     + B * T * cfg.n_kv_heads * cfg.hd * 2 * BF16 * 3)
        else:
            attn = 4.0 * B * T * cfg.n_heads * cfg.hd * cfg.n_layers
            cache = B * T * cfg.n_kv_heads * cfg.hd * 2 * kv_bytes \
                * cfg.n_layers
        cache_bytes_dev = cache / (dp * tp)          # split-KV layout
    if cfg.family == "ssm":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        nheads = d_inner // s.head_dim
        cache_bytes_dev = (B * nheads * s.d_state * s.head_dim * F32
                           * cfg.n_layers) / dp
    total = mm + logits + ssd + attn
    useful = _useful_flops(cfg, B, B, 2.0)
    w_dev = _div_params(cfg, tp) * F32               # f32 master read
    hbm = w_dev + cache_bytes_dev * 2 + B / dp * cfg.d_model * BF16 * \
        cfg.n_layers * 8
    return CellModel(total, useful, hbm,
                     notes=f"cache_dev={cache_bytes_dev/1e9:.2f}GB")


def model_cell(cfg: ModelConfig, shape: ShapeConfig, chips: int,
               tp: int = 16, kv_bytes: int = BF16) -> CellModel:
    if shape.kind == "train":
        return train_cell(cfg, shape, chips, tp)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, chips, tp)
    return decode_cell(cfg, shape, chips, tp, kv_bytes)
