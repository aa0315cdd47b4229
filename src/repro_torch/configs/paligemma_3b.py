"""paligemma-3b [vlm]: SigLIP vision frontend (STUB) + gemma-2b decoder.
[arXiv:2407.07726]

Vision tower supplies 256 patch embeddings (stubbed per the carve-out);
the language model prefixes them to the text stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    kind="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    mlp_variant="geglu",
    rope=True,
    norm="rmsnorm",
    scale_embed=True,
    enc_num_layers=0,         # vision tower fully stubbed (projector output)
    enc_seq_len=256,          # 256 image tokens prefix
    enc_is_stub=True,
    cross_attention=False,    # prefix-LM style, not cross-attn
    source="arXiv:2407.07726",
)
