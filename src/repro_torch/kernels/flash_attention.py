"""Flash attention: the wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
kernel).  On a CUDA tensor :func:`flash_attention` launches the kernel (or
raises); on a CPU tensor it runs the plain version
(:func:`repro_torch.kernels.ref.attention`, re-exported here as
``plain``).  The kernel note in the source says what bounds it and how.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention as plain

MAX_HEAD_DIM = 128


def _entry():
    fn = build.load("flash_attention").attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention of q (B,Tq,Hq,D) over k, v (B,Tk,Hkv,D) -> (B,Tq,Hq,D).

    Forward only; ``repro_torch.kernels.ops.attention`` adds the
    backward."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, sliding_window=sliding_window,
                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes float32")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d tensor, got {tuple(t.shape)}")
    B, Tq, Hq, D = q.shape
    Bk, Tk, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads, {Hkv} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = float(scale) if scale is not None else D ** -0.5
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Tq, Tk, Hq, Hkv, D, scale, int(bool(causal)),
                   int(sliding_window), int(q_offset),
                   torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
