"""Built-in FL strategies of the port; importing registers them."""
from repro_torch.fl.strategies import fedepth  # noqa: F401
