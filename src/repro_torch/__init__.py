"""repro_torch — the PyTorch/CUDA port of the TT-HF system.

A second package beside the JAX reference ``repro``, laid out module
for module like it (``repro_torch/core/mixing.py`` is the port of
``repro/core/mixing.py``). It imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``repro``: the jax-free host modules
(topology, ledger, data, round programs) are copies.

Ported so far: the paper's Algorithm 1 in simulation mode on the static
topology (``core.tthf.TTHFTrainer``, ``launch.train --mode sim``), with
D2D mixing carried by the hand-written CUDA kernel
``kernels.consensus_mix``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
