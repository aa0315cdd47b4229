"""Model operations of a Mamba-2 training step (forward and backward,
no recompute): 6 N per token for the N weights of the matrix products
(the input and output projections of every layer and the tied head over
the padded vocabulary rows), and three times the forward's operations
of the depthwise convolution and of the chunked SSD scan. Per token,
layer and chunk length Q the scan's forward takes 2 Q S for C B^T
(shared by the heads), and per head 2 Q P for the masked product with
x, 2 S P for the chunk state and 2 S P for the output from the carried
state."""
from perfbench.inputs import ssm_dims


def matmul_weights(m: dict) -> int:
    d, d_in, H, P, S, K, L = ssm_dims(m)
    return L * (d * (2 * d_in + 2 * S + H) + d_in * d) \
        + m["vocab_rows"] * d


def flops_per_token(m: dict) -> float:
    d, d_in, H, P, S, K, L = ssm_dims(m)
    Q = m["ssm_chunk"]
    conv = 2 * K * (d_in + 2 * S)
    scan = 2 * Q * S + H * (2 * Q * P + 4 * S * P)
    return 6.0 * matmul_weights(m) + 3.0 * L * (conv + scan)


def window_flops(cfg: dict, traffic: dict, intervals: int) -> float:
    tokens = intervals * traffic["tau"] * traffic["replicas"] \
        * traffic["batch_per_replica"] * traffic["seq_len"]
    return tokens * flops_per_token(cfg["model"])
