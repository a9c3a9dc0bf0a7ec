"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens
(MHA kv=32, LayerNorm+gelu). The EnCodec frontend is a STUB: train/prefill
``input_specs()`` provide precomputed frame embeddings; the 4-codebook
interleaving is collapsed to a single token stream (DESIGN.md).
[arXiv:2306.05284; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    norm="ln",
    mlp="gelu",
    rope=False,           # musicgen uses sinusoidal absolute embeddings
    frontend="embed",
)
