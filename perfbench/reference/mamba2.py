"""A Mamba-2 language model (arXiv:2405.21060; the SSD layer, one B/C
group shared by the heads) in plain PyTorch: the loss that the ``ssm``
model plug-in hands to the TT-HF interval of ``reference/scale.py``.

The model is the one the configuration states: tied embeddings over the
padded vocabulary rows; per layer ``x + out(ssd(norm(x)))`` with an
RMSNorm that scales by ``1 + scale``; the input projection split into
``z | x | B | C | dt``; a depthwise causal convolution without bias and
a SiLU on each of x, B and C; ``dt = softplus(dt + dt_bias)``, ``A =
-exp(A_log)``; the scan ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``,
``y_t = C_t h_t + D x_t``; the gate ``y * silu(z)`` (no gated norm: a
departure from the published block that the configuration records);
and the output projection. The scan is the chunked SSD algorithm of the
paper's minimal listing (segment sums within a chunk, states passed
between chunks), written again here."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.inputs import ssm_dims
from perfbench.reference.common import mm


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def causal_conv(x, w):
    """x (b, T, D), w (K, D): y_t = sum_i w_i x_{t-K+1+i}, zeros before 0."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + T] * w[i] for i in range(K))


def segsum(a):
    """a (..., Q) -> (..., Q, Q): [i, j] = a_{j+1} + ... + a_i for j <= i,
    -inf above the diagonal."""
    Q = a.shape[-1]
    x = a[..., None].expand(*a.shape, Q)
    below = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    return x.masked_fill(~below.logical_or(
        torch.eye(Q, dtype=torch.bool, device=a.device)), -torch.inf)


def ssd(X, A, B, C, Q: int, prec: str):
    """Chunked SSD from a zero state. X (b, T, H, P) = dt x; A (b, T, H)
    = dt a; B, C (b, T, S) -> y (b, T, H, P)."""
    b, T, H, P = X.shape
    S = B.shape[-1]
    c = T // Q
    X = X.reshape(b, c, Q, H, P)
    B = B.reshape(b, c, Q, S)
    C = C.reshape(b, c, Q, S)
    A = A.reshape(b, c, Q, H).permute(0, 3, 1, 2)           # (b, H, c, Q)
    Acum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                                # (b, H, c, Q, Q)
    CB = mm(C, B.transpose(-1, -2), prec)                   # (b, c, Q, Q)
    M = CB[:, None] * L                                     # (b, H, c, Q, Q)
    Xh = X.permute(0, 3, 1, 2, 4)                           # (b, H, c, Q, P)
    y_diag = mm(M, Xh, prec)                                # (b, H, c, Q, P)
    decay = torch.exp(Acum[..., -1:] - Acum)                # (b, H, c, Q)
    states = mm(B.transpose(-1, -2)[:, None],               # (b, H, c, S, P)
                Xh * decay[..., None], prec)
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    chunk_decay = torch.exp(segsum(F.pad(Acum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bhcsp->bhzsp", chunk_decay, states)[:, :, :-1]
    y_off = mm(C[:, None], states, prec) * torch.exp(Acum)[..., None]
    return (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, T, H, P)


def ssm_layer(p, x, m: dict, prec: str):
    d, d_in, H, P, S, K, _ = ssm_dims(m)
    b, T, _ = x.shape
    proj = mm(x, p["w_in"], prec)
    z, xs, Bm, Cm, dt = torch.split(proj, [d_in, d_in, S, S, H], dim=-1)
    xs = F.silu(causal_conv(xs, p["conv_x"]))
    Bm = F.silu(causal_conv(Bm, p["conv_B"]))
    Cm = F.silu(causal_conv(Cm, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(b, T, H, P)
    y = ssd(xh * dt[..., None], dt * -torch.exp(p["A_log"]), Bm, Cm,
            m["ssm_chunk"], prec)
    y = (y + xh * p["D"][:, None]).reshape(b, T, d_in) * F.silu(z)
    return mm(y, p["w_out"], prec)


def loss(params: dict, tokens, labels, m: dict, prec: str):
    """Mean next-token NLL over every vocabulary row. Each layer's
    activations are computed again in the backward, so that the whole
    model's fit in memory beside the replicas."""
    x = params["embed"][tokens.long()]
    lay = params["layers"]

    def layer(x, scale, p):
        return x + ssm_layer(p, rmsnorm(x, scale), m, prec)
    for i in range(m["num_layers"]):
        p = {k: v[i] for k, v in lay["ssm"].items()}
        x = checkpoint(layer, x, lay["ln"]["scale"][i], p,
                       use_reentrant=False)
    x = rmsnorm(x, params["ln_final"]["scale"])
    logits = mm(x, params["embed"].T, prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
