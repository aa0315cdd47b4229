"""``consensus_mix``: ``z_c <- V_c^Gamma z_c`` for N clusters of s
devices over M columns. It reads z (N, s, M), V (N, s, s) float32 and
the (N,) int32 rounds once and writes the result once; Gamma does not
change the bytes."""


def call_bytes(N: int, s: int, M: int, elem: int = 4) -> int:
    return 2 * N * s * M * elem + N * s * s * 4 + N * 4


def event_bytes(leaf_sizes, devices: int, clusters: int,
                elem: int = 4) -> int:
    """One consensus event: one call per parameter leaf, ``leaf_sizes``
    the per-device sizes."""
    s = devices // clusters
    return sum(call_bytes(clusters, s, M, elem) for M in leaf_sizes)
