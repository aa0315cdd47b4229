"""The one token sampler shared by every serving path — the port of
``repro/serving/sampling.py``.

Greedy decoding is ``argmax`` (the first maximal index, as in JAX).
Temperature sampling draws categorically from an explicit
``torch.Generator``: JAX's ``random.categorical`` streams cannot be
reproduced in torch, so parity with the reference holds at temperature
0 only.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits: torch.Tensor, *, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Sample one token per slot from the last logit position.

    logits: (B, 1, V) (or (B, V)); returns (B, 1) int32 on the logits'
    device. Greedy when ``temperature`` == 0, else categorical at
    ``temperature`` (``generator`` required, on the logits' device).
    """
    last = logits[:, -1] if logits.ndim == 3 else logits
    if temperature > 0:
        if generator is None:
            raise ValueError("temperature sampling requires a generator")
        probs = torch.softmax(last.float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        tok = torch.argmax(last, dim=-1)
    return tok[:, None].to(torch.int32)


__all__ = ["sample_tokens"]
