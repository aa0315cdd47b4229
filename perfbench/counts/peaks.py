"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet,
at its 700 W limit."""

# HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
# 3xTF32 on the tensor cores (three TF32 products per float32 product):
# the card's fastest route to float32 accuracy, 495 / 3 TFLOP/s dense.
# The float32 SIMT peak (67 TFLOP/s) would put a sound float32 GEMM on
# the tensor cores above 100 %.
F32_FLOPS_PER_S = 495e12 / 3
