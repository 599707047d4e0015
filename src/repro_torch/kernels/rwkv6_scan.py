"""RWKV6 WKV scan: the wrapper of the CUDA kernel ``csrc/rwkv6_scan.cu``.

Replaces ``repro.kernels.rwkv6_scan.rwkv6_scan`` (a Pallas TPU kernel).
On a CUDA tensor :func:`rwkv6_scan` launches the kernel (or raises); on a
CPU tensor it runs the plain version (:func:`repro_torch.kernels.ref.
rwkv6_scan`, re-exported here as ``plain``).  The kernel note in the
source says what bounds it and how.  A ``(G, H, D)`` ``u`` is one per
group of B/G batch rows, all G in one launch (the stacked path's clients,
``kernels/ops.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import PLAIN_DEVICES
from repro_torch.kernels.ref import rwkv6_scan as plain


def _lib():
    lib = build.load("rwkv6_scan")
    if lib.wkv6_fwd.argtypes is None:
        lib.wkv6_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
        lib.wkv6_fwd.restype = ctypes.c_int
        lib.wkv6_supported.argtypes = [ctypes.c_int]
        lib.wkv6_supported.restype = ctypes.c_int
    return lib


def rwkv6_scan(r: torch.Tensor,      # (B, T, H, D)
               k: torch.Tensor,
               v: torch.Tensor,
               w: torch.Tensor,      # decay logits; decay = exp(-exp(w))
               u: torch.Tensor,      # (H, D) or (G, H, D)
               initial_state: Optional[torch.Tensor] = None,  # (B,H,D,D)
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,D), final state (B,H,D,D)), both fp32.  Forward
    only; ``repro_torch.kernels.ops.rwkv6`` adds the backward."""
    if r.device.type in PLAIN_DEVICES:
        return plain(r, k, v, w, u, initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be (B, T, H, D), got "
                         f"{tuple(r.shape)}")
    B, T, H, D = r.shape
    groups = u.shape[0] if u.dim() == 3 else 1
    if B % groups:
        raise ValueError(f"rwkv6_scan: {B} batch rows do not split into "
                         f"{groups} groups")
    if initial_state is None:
        initial_state = r.new_zeros(B, H, D, D)
    args = (("r", r, (B, T, H, D)), ("k", k, (B, T, H, D)),
            ("v", v, (B, T, H, D)), ("w", w, (B, T, H, D)),
            ("u", u, (groups, H, D) if u.dim() == 3 else (H, D)),
            ("initial_state", initial_state, (B, H, D, D)))
    build.check_args("rwkv6_scan", r.device, args)
    y = torch.empty_like(r)
    state = torch.empty_like(initial_state)
    lib = _lib()
    if not lib.wkv6_supported(D):
        raise ValueError(f"rwkv6_scan: head_dim {D} does not fit the "
                         f"kernel's block")
    err = lib.wkv6_fwd(*(t.data_ptr() for _, t, _ in args), y.data_ptr(),
                       state.data_ptr(), B, T, H, D, groups,
                       torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0
