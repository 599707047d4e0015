"""NVIDIA H100 SXM constants (per card) for the roofline model (port of
``repro.roofline.hw``, whose values are a TPU v5e's).

Sources: NVIDIA H100 Tensor Core GPU data sheet (SXM5 column): FP32 67
TFLOP/s, TF32 Tensor Core 495 TFLOP/s and BF16 Tensor Core 989 TFLOP/s
(dense, without sparsity), GPU memory 80 GB at 3.35 TB/s, NVLink 900 GB/s
(18 fourth-generation links; the sum of both directions).
"""

PEAK_FLOPS_FP32 = 67e12       # FLOP/s on the CUDA cores (the port: TF32 off)
PEAK_FLOPS_TF32 = 495e12      # FLOP/s on the tensor cores, TF32
PEAK_FLOPS_BF16 = 989e12      # FLOP/s on the tensor cores, BF16
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # 80 GB
# the collective term: what one card injects into NVLink, one direction
# (900 GB/s both directions together)
NVLINK_BW = 450e9             # bytes/s
