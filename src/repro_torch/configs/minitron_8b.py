"""minitron-8b [dense] — width-pruned nemotron-4; GQA kv=8, huge 256k vocab
stresses embedding/vocab sharding. [arXiv:2407.14679; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    norm="rms",
    mlp="gelu",          # nemotron uses squared-relu; gelu is the close stand-in
    rope=True,
)
