"""Model families of the port (dense transformer so far)."""
from repro_torch.models.api import LM, build, image_model  # noqa: F401
