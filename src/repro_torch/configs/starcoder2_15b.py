"""starcoder2-15b [dense] — GQA, RoPE, LayerNorm + gelu MLP, learned-abs+rope
hybrid in HF; backbone here uses RoPE. [arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    norm="ln",
    mlp="gelu",
    qkv_bias=True,       # starcoder2 uses attention bias
    rope=True,
)
