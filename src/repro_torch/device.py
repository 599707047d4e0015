"""Where the port runs: ``cuda`` unless the caller asks for the CPU, and
in fp32 there, as the reference computes."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def use_fp32() -> None:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's matmuls, for
    the whole process.  PyTorch leaves it on for convolutions by
    default; the port computes in fp32.  Process-wide, not scoped: a
    convolution's backward reads the flag when autograd runs it, after
    any scope around its forward has closed."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  Raises when the GPU is asked for (or
    implied) and there is none: the port never carries on quietly on the
    CPU — pass ``device="cpu"`` for that.  A CUDA device sets the fp32
    policy (:func:`use_fp32`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        use_fp32()
    return dev
