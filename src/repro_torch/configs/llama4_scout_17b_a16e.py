"""llama4-scout-17b-a16e [moe]: 16 experts top-1, MoE every layer,
early-fusion text backbone. [hf:meta-llama/Llama-4-Scout-17B-16E]

~100B total params, ~17B active with top-1 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    kind="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    mlp_variant="swiglu",
    rope=True,
    norm="rmsnorm",
    tie_embeddings=False,
    moe_num_experts=16,
    moe_top_k=1,
    moe_every=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
