"""whisper-small [audio]: enc-dec ASR backbone. [arXiv:2212.04356]

12L (x2: encoder+decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
Conv/mel frontend is a STUB per the assignment carve-out: input_specs()
supplies precomputed frame embeddings (1500, 768).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    kind="audio",
    num_layers=12,            # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,          # full MHA
    d_ff=3072,
    vocab_size=51_865,
    mlp_variant="gelu",
    rope=False,               # whisper uses learned/sinusoidal positions
    norm="layernorm",
    tie_embeddings=True,
    enc_num_layers=12,
    enc_seq_len=1500,         # 30s audio -> 1500 frames
    enc_is_stub=True,
    cross_attention=True,
    max_seq_len=32_768,       # backbone exercised beyond the 448 deploy cap
    source="arXiv:2212.04356",
)
