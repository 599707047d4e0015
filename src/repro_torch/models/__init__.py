"""Model families of the port: dense and VLM transformers, mamba2, rwkv6,
the hybrid zamba2, the encoder-decoder whisper, PreResNet and ViT."""
from repro_torch.models.api import LM, build, image_model, init_cache  # noqa: F401
