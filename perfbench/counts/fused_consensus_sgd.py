"""``fused_consensus_sgd``: ``W_c (w_c - eta g_c)`` for N clusters of s
replicas over P columns. It reads w and g (N, s, P), W (N, s, s)
float32 and the float32 eta once and writes the result once."""


def call_bytes(N: int, s: int, P: int, elem: int = 4) -> int:
    return 3 * N * s * P * elem + N * s * s * 4 + 4
