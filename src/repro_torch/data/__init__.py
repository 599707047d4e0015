"""Data pipelines (port of ``repro.data``): the synthetic token stream."""
from repro_torch.data.tokens import TokenPipeline  # noqa: F401
