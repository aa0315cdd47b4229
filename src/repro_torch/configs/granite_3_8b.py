"""granite-3-8b [dense]: GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    kind="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    mlp_variant="swiglu",
    rope=True,
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
