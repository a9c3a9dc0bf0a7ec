"""llava-next-34b [vlm] — language backbone (Yi-34B-shaped: 60L, d=7168,
56H/kv=8). The vision tower + anyres tiling is a STUB: ``input_specs()``
provides precomputed patch embeddings prepended to the prompt.
[hf:llava-hf/llava-v1.6; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    norm="rms",
    mlp="swiglu",
    rope=True,
    frontend="embed",
)
