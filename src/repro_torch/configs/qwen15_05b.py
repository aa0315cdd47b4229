"""qwen1.5-0.5b [dense]: QKV bias, full MHA. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    kind="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    mlp_variant="swiglu",
    rope=True,
    qkv_bias=True,
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
