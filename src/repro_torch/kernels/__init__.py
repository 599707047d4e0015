"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Models call ``repro_torch.kernels.ops``, never a kernel directly.
"""
