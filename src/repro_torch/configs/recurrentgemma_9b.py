"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 2:1. [arXiv:2402.19427]

38 blocks: pattern (recurrent, recurrent, local-attention) repeating.
Sub-quadratic by construction => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    kind="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,           # MQA on the local-attention layers
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    mlp_variant="geglu",
    rope=True,
    norm="rmsnorm",
    scale_embed=True,
    local_attn_every=3,       # 1 attention per 2 recurrent blocks
    attention_window=2048,    # local (sliding window) attention
    rglru_width=4096,
    source="arXiv:2402.19427",
)
