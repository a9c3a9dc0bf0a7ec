"""Registry of the assigned architectures, plus their reduced twins.

Port of ``repro.configs.registry``: ``ARCHS`` holds the reference's ten
configs in its order; ``smoke_config`` builds the same reduced
same-family twin as the reference, small enough for a CPU forward.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (granite_moe_1b, granite_moe_3b, hymba_1_5b,
                                 llava_next_34b, mamba2_370m, minitron_8b,
                                 musicgen_large, qwen1_5_32b, starcoder2_15b,
                                 yi_6b)
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

ARCHS = {
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "yi-6b": yi_6b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family twin: few layers, narrow width, tiny vocab."""
    full = get_arch(name)
    kv = min(full.n_kv_heads, 2) if full.n_kv_heads else 0
    heads = 0
    if full.n_heads:
        # keep the GQA group structure (heads multiple of kv heads)
        group = max(full.n_heads // max(full.n_kv_heads, 1), 1)
        heads = kv * group if kv else 4
        heads = min(heads, 8) or 4
        kv = max(heads // group, 1)
    updates = dict(
        n_layers=4 if full.family == "hybrid" else 3,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32 if full.n_heads else 0,
        d_ff=256 if full.d_ff else 0,
        vocab=512,
        attn_chunk=64,
        remat="none",
        dtype="float32",
        window=full.window and 64,
    )
    if full.moe is not None:
        updates["moe"] = MoEConfig(num_experts=8, top_k=2, expert_dff=64)
    if full.ssm is not None:
        updates["ssm"] = SSMConfig(
            d_state=min(full.ssm.d_state, 16), head_dim=32,
            expand=full.ssm.expand, conv_width=4, chunk=32)
    if full.family == "hybrid":
        # parallel-head constraint: n_heads * head_dim == expand * d_model
        updates["n_heads"] = (full.ssm.expand * 128) // 32
        updates["n_kv_heads"] = 2
        updates["head_dim"] = 32
    return dataclasses.replace(full, **updates)
