"""The Mamba-2 model plug-in (``model.kind`` ``ssm``) of the scale
driver: the program's configuration, the weights from the seed, the
plain model's loss (``reference/mamba2.py``) and the model operations of
a traced window (``counts/mamba2_train.py``).

A configuration of another model kind brings a plug-in of its own,
``models/<kind>.py``, with these four names (``harness.model_plugin``).
"""
from __future__ import annotations

from perfbench import inputs
from perfbench.counts import mamba2_train
from perfbench.reference import mamba2


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of the file's ``model`` block; the
    program has to pad the vocabulary to the file's ``vocab_rows``."""
    from repro_torch.configs import ModelConfig
    m = cfg["model"]
    mc = ModelConfig(
        name=cfg["name"], kind="ssm", num_layers=m["num_layers"],
        d_model=m["d_model"], num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=m["vocab_size"], rope=False, norm=m["norm"],
        tie_embeddings=m["tie_embeddings"],
        ssm_state_dim=m["ssm_state_dim"], ssm_expand=m["ssm_expand"],
        ssm_head_dim=m["ssm_head_dim"], ssm_num_heads=m["ssm_num_heads"],
        ssm_chunk=m["ssm_chunk"], ssm_conv_width=m["ssm_conv_width"])
    if mc.padded_vocab != m["vocab_rows"]:
        raise ValueError(f"the program pads the vocabulary to "
                         f"{mc.padded_vocab} rows, the configuration to "
                         f"{m['vocab_rows']}")
    return mc


def weights(cfg: dict, seed: int, device) -> dict:
    return inputs.mamba2_weights(cfg, seed, device)


def loss(params: dict, tokens, labels, cfg: dict, prec: str):
    return mamba2.loss(params, tokens, labels, cfg["model"], prec)


def window_flops(cfg: dict, traffic: dict, intervals: int,
                 facts: dict) -> float:
    """Every token of the intervals passes every layer: ``facts`` is
    not needed."""
    return mamba2_train.window_flops(cfg, traffic, intervals)
