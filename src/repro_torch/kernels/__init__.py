"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (the CPU path and the card's correctness yardstick).

Ported: ``consensus_mix`` (CUDA C++, ``csrc/consensus_mix.cu``; import
it from :mod:`repro_torch.kernels.consensus_mix`). The other TPU
kernels of ``repro/kernels/`` are still to port (ROADMAP.md, Queue 2).
CUDA sources build at first use (:mod:`.build`), never at import, so
the package imports on a machine without ``nvcc``.
"""
