"""mamba2-370m [ssm] — attention-free SSD (state-space duality), 48 layers,
d_model=1024, ssm_state=128, no MLP (d_ff=0). Runs long_500k (O(1) state).
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    norm="rms",
    rope=False,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
)
