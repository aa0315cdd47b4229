"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (the CPU path and the card's correctness yardstick).

Ported, all CUDA C++ in ``csrc/``: ``consensus_mix``
(:mod:`repro_torch.kernels.consensus_mix`, the sim path's D2D mixing),
``fused_consensus_sgd`` (:mod:`repro_torch.kernels.fused_consensus_sgd`,
the scale path's block-end) and ``fused_sgd``
(:mod:`repro_torch.kernels.fused_sgd`, the one-replica instance of
``csrc/fused_consensus_sgd.cu``, unwired as in the reference). The
other TPU kernels of ``repro/kernels/`` are still to port (ROADMAP.md,
Queue 2). CUDA sources build at first use (:mod:`.build`), never at
import, so the package imports on a machine without ``nvcc``.
"""
