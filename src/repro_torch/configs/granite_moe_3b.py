"""granite-moe-3b-a800m [moe] — 40 experts top-8 (40 % 16 != 0: expert dim
degrades to replication, d_ff sharding documented in DESIGN.md), GQA kv=8.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    norm="rms",
    mlp="swiglu",
    rope=True,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, expert_dff=512),
)
