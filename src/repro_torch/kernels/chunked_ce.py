"""Chunked cross-entropy: the wrapper of the CUDA kernel ``csrc/chunked_ce.cu``.

Replaces ``repro.kernels.chunked_ce.chunked_cross_entropy`` (a Pallas TPU
kernel).  The kernel returns the per-row NLL (:func:`cross_entropy_rows`);
:func:`chunked_cross_entropy` takes the mean over valid rows, as the
reference does after its ``pallas_call``.  On a CUDA tensor
:func:`cross_entropy_rows` launches the kernel (or raises); on a CPU
tensor it runs the plain version (:func:`repro_torch.kernels.ref.
cross_entropy_rows`, re-exported here as ``plain_rows``; the plain mean,
``ref.cross_entropy_logits``, is ``plain``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import cross_entropy_logits as plain
from repro_torch.kernels.ref import cross_entropy_rows as plain_rows


def _lib():
    lib = build.load("chunked_ce")
    if lib.ce_fwd.argtypes is None:
        lib.ce_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
        lib.ce_fwd.restype = ctypes.c_int
        lib.ce_num_vocab_tiles.argtypes = [ctypes.c_int]
        lib.ce_num_vocab_tiles.restype = ctypes.c_int
    return lib


def cross_entropy_rows(hidden: torch.Tensor,    # (B, T, D)
                       lm_head: torch.Tensor,   # (D, V)
                       labels: torch.Tensor,    # (B, T); -100 = ignore
                       ) -> torch.Tensor:
    """The per-token NLL, shape (B*T,), 0 where the label is ignored: what
    the kernel writes before the mean.

    ``lm_head`` is either contiguous or the transpose of a contiguous
    (V, D) table (a tied head, ``embed.T``), which the kernel reads in
    place."""
    if hidden.device.type == "cpu":
        return plain_rows(hidden, lm_head, labels)
    if hidden.device.type != "cuda":
        raise ValueError(f"chunked_cross_entropy: unsupported device "
                         f"{hidden.device}")
    # a tied head: the transpose of a contiguous (V, D) table
    head_is_vd = (lm_head.dim() == 2 and not lm_head.is_contiguous()
                  and lm_head.t().is_contiguous())
    build.check_args("chunked_cross_entropy", hidden.device,
                     (("hidden", hidden, None),
                      ("lm_head", lm_head.t() if head_is_vd else lm_head,
                       None)))
    if labels.device != hidden.device:
        raise ValueError(f"chunked_cross_entropy: labels on {labels.device}, "
                         f"expected {hidden.device}")
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
    nll = torch.empty(N, device=hidden.device, dtype=torch.float32)
    if N == 0:
        return nll
    lbl = labels.reshape(N).to(torch.int32).contiguous()
    lib = _lib()
    nvt = lib.ce_num_vocab_tiles(V)
    partials = torch.empty(3 * N * nvt, device=hidden.device,
                           dtype=torch.float32)
    err = lib.ce_fwd(hidden.data_ptr(), lm_head.data_ptr(), lbl.data_ptr(),
                     partials.data_ptr(), nll.data_ptr(), N, D, V,
                     int(head_is_vd),
                     torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "chunked_cross_entropy")
    chunked_cross_entropy.launches += 1
    return nll


def chunked_cross_entropy(hidden: torch.Tensor,    # (B, T, D)
                          lm_head: torch.Tensor,   # (D, V)
                          labels: torch.Tensor,    # (B, T); -100 = ignore
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean NLL over valid labels, n_valid).  Forward only;
    ``repro_torch.kernels.ops.cross_entropy`` adds the backward.  The
    kernel's launches are counted here (``launches``)."""
    nll = cross_entropy_rows(hidden, lm_head, labels)
    n = (labels >= 0).sum().clamp(min=1)
    return nll.sum() / n, n


chunked_cross_entropy.launches = 0
