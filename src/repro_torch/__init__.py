"""PyTorch / CUDA port of the FeDepth reproduction (``repro``), for NVIDIA
Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and never imports it (nor JAX).  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; with no GPU and no ``device="cpu"`` they
raise.  Every TPU kernel on a ported path is a hand-written CUDA kernel
under ``kernels/csrc/`` (see README "PyTorch / H100 port").
"""
