"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]

48L d_model=1024, ssm_state=128, expand=2 => d_inner=2048, head_dim=64
=> 32 SSD heads. Sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    kind="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    rope=False,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_num_heads=32,         # (expand * d_model) / head_dim
    ssm_chunk=256,
    ssm_conv_width=4,
    source="arXiv:2405.21060",
)
