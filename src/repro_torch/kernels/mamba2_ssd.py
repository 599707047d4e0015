"""Mamba2 SSD scan: the wrapper of the CUDA kernel ``csrc/mamba2_ssd.cu``.

Replaces ``repro.kernels.mamba2_ssd.mamba2_scan`` (a Pallas TPU kernel).
On a CUDA tensor :func:`mamba2_scan` launches the kernel (or raises); on a
CPU tensor it runs the plain version (:func:`repro_torch.kernels.ref.
mamba2_scan`, re-exported here as ``plain``).  The kernel note in the
source says what bounds it and how.  A ``(G, H)`` ``A`` and ``D`` are one
pair per group of B/G batch rows, all G in one launch (the stacked path's
clients, ``kernels/ops.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import PLAIN_DEVICES
from repro_torch.kernels.ref import mamba2_scan as plain


def _lib():
    lib = build.load("mamba2_ssd")
    if lib.ssd_fwd.argtypes is None:
        lib.ssd_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                + [ctypes.c_void_p])
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_supported.argtypes = [ctypes.c_int] * 2
        lib.ssd_supported.restype = ctypes.c_int
    return lib


def mamba2_scan(x: torch.Tensor,     # (B, T, H, P)
                dt: torch.Tensor,    # (B, T, H)
                A: torch.Tensor,     # (H,) or (G, H)
                Bm: torch.Tensor,    # (B, T, N)
                Cm: torch.Tensor,    # (B, T, N)
                D: torch.Tensor,     # (H,) or (G, H)
                initial_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,P), final state (B,H,P,N)), both fp32.  Forward
    only; ``repro_torch.kernels.ops.mamba2`` adds the backward."""
    if x.device.type in PLAIN_DEVICES:
        return plain(x, dt, A, Bm, Cm, D, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_scan: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"mamba2_scan: x must be (B, T, H, P), got "
                         f"{tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    groups = A.shape[0] if A.dim() == 2 else 1
    if B % groups:
        raise ValueError(f"mamba2_scan: {B} batch rows do not split into "
                         f"{groups} groups")
    hs = (groups, H) if A.dim() == 2 else (H,)
    if initial_state is None:
        initial_state = x.new_zeros(B, H, P, N)
    args = (("x", x, (B, T, H, P)), ("dt", dt, (B, T, H)), ("A", A, hs),
            ("Bm", Bm, (B, T, N)), ("Cm", Cm, (B, T, N)), ("D", D, hs),
            ("initial_state", initial_state, (B, H, P, N)))
    build.check_args("mamba2_scan", x.device, args)
    y = torch.empty_like(x)
    state = torch.empty_like(initial_state)
    lib = _lib()
    if not lib.ssd_supported(P, N):
        raise ValueError(f"mamba2_scan: head_dim {P} with state {N} does not "
                         f"fit the kernel's block")
    err = lib.ssd_fwd(*(t.data_ptr() for _, t, _ in args), y.data_ptr(),
                      state.data_ptr(), B, T, H, P, N, groups,
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mamba2_scan")
    mamba2_scan.launches += 1
    return y, state


mamba2_scan.launches = 0
