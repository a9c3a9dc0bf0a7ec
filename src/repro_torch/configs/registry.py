"""Registry of the architectures the port runs, plus their reduced twins.

Port of ``repro.configs.registry``.  ``ARCHS`` holds the configs whose
family the port runs (dense: yi-6b); the reference's other configs, and
the moe/ssm/hybrid branches of ``smoke_config``, wait for their families
(ROADMAP.md, Queue 1 #11a).  ``smoke_config`` builds the same reduced twin
as the reference.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import yi_6b
from repro_torch.models.config import ModelConfig

ARCHS = {
    "yi-6b": yi_6b.CONFIG,
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
        n_layers=3,
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
    return dataclasses.replace(full, **updates)
