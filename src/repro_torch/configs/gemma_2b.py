"""gemma-2b [dense]: GeGLU, head_dim=256, MQA. [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    kind="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    mlp_variant="geglu",
    rope=True,
    norm="rmsnorm",
    scale_embed=True,         # gemma scales embeddings by sqrt(d_model)
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
