"""starcoder2-3b [dense]: GQA, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    kind="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    mlp_variant="gelu",       # starcoder2 uses a plain GELU MLP
    rope=True,
    norm="layernorm",
    qkv_bias=True,            # starcoder2 keeps biases
    tie_embeddings=True,
    sliding_window=4096,      # starcoder2-3b ships with SWA-4096
    source="arXiv:2402.19173",
)
