"""Roofline analysis of the dry run's per-device counts (NVIDIA H100 SXM)."""
from repro_torch.roofline.analysis import Roofline, analyze  # noqa: F401
