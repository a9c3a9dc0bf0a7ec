"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every block,
sliding-window attention except at layers {0, L/2, L-1} (full/global), GQA
kv=5, ssm_state=16. Meta-tokens are omitted (DESIGN.md deviation note).
[arXiv:2411.13676; hf]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    norm="rms",
    mlp="swiglu",
    rope=True,
    window=1024,
    global_every=16,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=1, conv_width=4, chunk=256),
)
