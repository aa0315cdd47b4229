"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, MoE every other
layer (interleaved, per the Llama-4 arch), early-fusion text backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Total ~400B params (24 MoE layers x 128 experts x 3*d*d_ff ~ 386B + dense),
~17B active per token with top-1 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
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
    moe_num_experts=128,
    moe_top_k=1,
    moe_every=2,              # interleaved MoE (every other layer)
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
