"""Chunked cross-entropy: the wrapper of the CUDA kernel ``csrc/chunked_ce.cu``.

Replaces ``repro.kernels.chunked_ce.chunked_cross_entropy`` (a Pallas TPU
kernel).  On a CUDA tensor :func:`chunked_cross_entropy` launches the
kernel (or raises); on a CPU tensor it runs the plain version
(:func:`repro_torch.kernels.ref.cross_entropy_logits`, re-exported here as
``plain``).  The kernel returns the per-row NLL; the mean over valid rows
is taken here, as the reference does after its ``pallas_call``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import cross_entropy_logits as plain


def _lib():
    lib = build.load("chunked_ce")
    if lib.ce_fwd.argtypes is None:
        lib.ce_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
        lib.ce_fwd.restype = ctypes.c_int
        lib.ce_num_vocab_tiles.argtypes = [ctypes.c_int]
        lib.ce_num_vocab_tiles.restype = ctypes.c_int
    return lib


def chunked_cross_entropy(hidden: torch.Tensor,    # (B, T, D)
                          lm_head: torch.Tensor,   # (D, V)
                          labels: torch.Tensor,    # (B, T); -100 = ignore
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean NLL over valid labels, n_valid).  Forward only;
    ``repro_torch.kernels.ops.cross_entropy`` adds the backward."""
    if hidden.device.type == "cpu":
        return plain(hidden, lm_head, labels)
    if hidden.device.type != "cuda":
        raise ValueError(f"chunked_cross_entropy: unsupported device "
                         f"{hidden.device}")
    for name, t in (("hidden", hidden), ("lm_head", lm_head)):
        if t.device != hidden.device or labels.device != hidden.device:
            raise ValueError("chunked_cross_entropy: inputs on different "
                             "devices")
        if t.dtype != torch.float32:
            raise TypeError(f"chunked_cross_entropy: {name} is {t.dtype}; "
                            f"the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"chunked_cross_entropy: {name} must be "
                             f"contiguous")
    if hidden.dim() != 3 or lm_head.dim() != 2 \
            or lm_head.shape[0] != hidden.shape[2] \
            or tuple(labels.shape) != tuple(hidden.shape[:2]):
        raise ValueError(f"chunked_cross_entropy: shapes hidden "
                         f"{tuple(hidden.shape)}, lm_head "
                         f"{tuple(lm_head.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"chunked_cross_entropy: labels are {labels.dtype}")
    B, T, D = hidden.shape
    V = lm_head.shape[1]
    N = B * T
    lbl = labels.reshape(N).to(torch.int32).contiguous()
    valid = lbl >= 0
    n = valid.sum().clamp(min=1)
    if N == 0:
        return hidden.new_zeros(()), n
    lib = _lib()
    nvt = lib.ce_num_vocab_tiles(V)
    partials = torch.empty(3 * N * nvt, device=hidden.device,
                           dtype=torch.float32)
    nll = torch.empty(N, device=hidden.device, dtype=torch.float32)
    err = lib.ce_fwd(hidden.data_ptr(), lm_head.data_ptr(), lbl.data_ptr(),
                     partials.data_ptr(), nll.data_ptr(), N, D, V,
                     torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "chunked_cross_entropy")
    chunked_cross_entropy.launches += 1
    return nll.sum() / n, n


chunked_cross_entropy.launches = 0
