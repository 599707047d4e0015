"""Built-in FL strategies of the port; importing registers them."""
from repro_torch.fl.strategies import (depthfl, fedavg, fedepth,  # noqa: F401
                                       heterofl, splitmix)
