"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (the CPU path and the card's correctness yardstick).

Ported, all CUDA C++ in ``csrc/``: ``consensus_mix``
(:mod:`repro_torch.kernels.consensus_mix`, the sim path's D2D mixing),
``fused_consensus_sgd`` (:mod:`repro_torch.kernels.fused_consensus_sgd`,
the scale path's block-end) and ``fused_sgd``
(:mod:`repro_torch.kernels.fused_sgd`, a streaming kernel of its own in
``csrc/fused_consensus_sgd.cu`` that shares the SGD step, unwired as in
the reference),
``paged_decode`` (:mod:`repro_torch.kernels.paged_decode`, the paged
serving path's decode attention) and ``ssd_scan``
(:mod:`repro_torch.kernels.ssd_scan`, the Mamba-2 SSD scan of the ssm
kind's prefills): all five TPU kernels of ``repro/kernels/``. Beside
them, two that replace no TPU kernel: ``sim_nn_forward`` and
``sim_nn_update`` (:mod:`repro_torch.kernels.sim_nn_step`, the sim
path's local SGD step of the ``nn`` model, which the reference leaves to
XLA). CUDA sources build at first use (:mod:`.build`), never at import,
so the package imports on a machine without ``nvcc``.
"""
