"""qwen1.5-32b [dense] — GQA kv=40 (near-MHA: the largest KV cache of the
pool — the memory-roofline stress cell), QKV bias. [hf:Qwen/Qwen1.5; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    norm="rms",
    mlp="swiglu",
    qkv_bias=True,
    rope=True,
)
