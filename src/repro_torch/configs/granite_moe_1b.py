"""granite-moe-1b-a400m [moe] — 32 experts top-8, per-expert d_ff=512,
GQA kv=8. Expert-parallel over the model axis (32 % 16 == 0).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    norm="rms",
    mlp="swiglu",
    rope=True,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, expert_dff=512),
)
