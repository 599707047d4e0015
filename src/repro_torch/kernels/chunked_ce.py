"""Chunked cross-entropy: the wrapper of the CUDA kernel ``csrc/chunked_ce.cu``.

Replaces ``repro.kernels.chunked_ce.chunked_cross_entropy`` (a Pallas TPU
kernel).  The kernel returns the per-row NLL (:func:`cross_entropy_rows`);
:func:`chunked_cross_entropy` takes the mean over valid rows, as the
reference does after its ``pallas_call``.  On a CUDA tensor
:func:`cross_entropy_rows` launches the kernel (or raises); on a CPU
tensor it runs the plain version (:func:`repro_torch.kernels.ref.
cross_entropy_rows`, re-exported here as ``plain_rows``; the plain mean,
``ref.cross_entropy_logits``, is ``plain``).  A ``(G, D, V)`` head is one
head per group of B/G batch rows, all G in one launch (the stacked path's
clients, ``kernels/ops.py``).  :func:`cross_entropy_lse_gold` is one
rank's share of a head split over the vocab (the sharded route): the
same launch, each row's log-sum-exp and gold logit folded from the
kernel's per-tile partials.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import PLAIN_DEVICES
from repro_torch.kernels.ref import cross_entropy_logits as plain
from repro_torch.kernels.ref import cross_entropy_lse_gold as plain_lse_gold
from repro_torch.kernels.ref import cross_entropy_rows as plain_rows


def _lib():
    lib = build.load("chunked_ce")
    if lib.ce_fwd.argtypes is None:
        lib.ce_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
        lib.ce_fwd.restype = ctypes.c_int
        lib.ce_num_vocab_tiles.argtypes = [ctypes.c_int]
        lib.ce_num_vocab_tiles.restype = ctypes.c_int
    return lib


def cross_entropy_rows(hidden: torch.Tensor,    # (B, T, D)
                       lm_head: torch.Tensor,   # (D, V) or (G, D, V)
                       labels: torch.Tensor,    # (B, T); -100 = ignore
                       ) -> torch.Tensor:
    """The per-token NLL, shape (B*T,), 0 where the label is ignored: what
    the kernel writes before the mean.

    ``lm_head`` is either contiguous or the transpose of a contiguous
    (V, D) table (a tied head, ``embed.T``), which the kernel reads in
    place; a (G, D, V) stack of heads likewise (``embed.transpose(1, 2)``
    of a (G, V, D) stack), G dividing B."""
    if hidden.device.type in PLAIN_DEVICES:
        return plain_rows(hidden, lm_head, labels)
    return _launch(hidden, lm_head, labels)[0]


def cross_entropy_lse_gold(hidden: torch.Tensor,    # (B, T, D)
                           lm_head: torch.Tensor,   # (D, V)
                           labels: torch.Tensor,    # (B, T) in [0, V]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per token, shape (B*T,) each: the log-sum-exp of the logits over
    the head's V columns and the gold logit, 0 where the label is V (a
    column no tile holds): one rank's share of a head split over the
    vocab (``kernels/ops.py``).  One launch; both are folded from the
    kernel's per-tile (max, sum-exp, gold) partials."""
    if hidden.device.type in PLAIN_DEVICES:
        return plain_lse_gold(hidden, lm_head, labels)
    _, partials = _launch(hidden, lm_head, labels)
    pm, pl, pg = partials                        # (N, vocab tiles) each
    m = pm.max(1).values
    lse = m + torch.log((pl * torch.exp(pm - m[:, None])).sum(1))
    return lse, pg.sum(1)


def _launch(hidden, lm_head, labels):
    """One launch of the kernel: (the NLL (N,), its partials (max,
    sum-exp, gold), each (N, vocab tiles))."""
    if hidden.device.type != "cuda":
        raise ValueError(f"chunked_cross_entropy: unsupported device "
                         f"{hidden.device}")
    if hidden.dim() != 3 or lm_head.dim() not in (2, 3) \
            or lm_head.shape[-2] != hidden.shape[2] \
            or tuple(labels.shape) != tuple(hidden.shape[:2]) \
            or (lm_head.dim() == 3 and hidden.shape[0] % lm_head.shape[0]):
        raise ValueError(f"chunked_cross_entropy: shapes hidden "
                         f"{tuple(hidden.shape)}, lm_head "
                         f"{tuple(lm_head.shape)}, labels "
                         f"{tuple(labels.shape)}")
    groups = lm_head.shape[0] if lm_head.dim() == 3 else 1
    # a tied head: the transpose of a contiguous (V, D) table
    table = lm_head.transpose(-1, -2)
    head_is_vd = not lm_head.is_contiguous() and table.is_contiguous()
    build.check_args("chunked_cross_entropy", hidden.device,
                     (("hidden", hidden, None),
                      ("lm_head", table if head_is_vd else lm_head, None)))
    if labels.device != hidden.device:
        raise ValueError(f"chunked_cross_entropy: labels on {labels.device}, "
                         f"expected {hidden.device}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"chunked_cross_entropy: labels are {labels.dtype}")
    B, T, D = hidden.shape
    V = lm_head.shape[-1]
    N = B * T
    nll = torch.empty(N, device=hidden.device, dtype=torch.float32)
    if N == 0:
        return nll, nll.view(3, 0, 0)
    lbl = labels.reshape(N).to(torch.int32).contiguous()
    lib = _lib()
    nvt = lib.ce_num_vocab_tiles(V)
    partials = torch.empty(3 * N * nvt, device=hidden.device,
                           dtype=torch.float32)
    err = lib.ce_fwd(hidden.data_ptr(), lm_head.data_ptr(), lbl.data_ptr(),
                     partials.data_ptr(), nll.data_ptr(), N, D, V,
                     int(head_is_vd), groups,
                     torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "chunked_cross_entropy")
    chunked_cross_entropy.launches += 1
    return nll, partials.view(3, N, nvt)


def chunked_cross_entropy(hidden: torch.Tensor,    # (B, T, D)
                          lm_head: torch.Tensor,   # (D, V) or (G, D, V)
                          labels: torch.Tensor,    # (B, T); -100 = ignore
                          *, groups: Optional[int] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean NLL over valid labels, n_valid).  With a (G, D, V)
    head, or ``groups`` G over a shared (D, V) one, each group of B/G
    batch rows has its own: (means (G,), n_valid (G,)).  Forward only;
    ``repro_torch.kernels.ops.cross_entropy`` adds the backward.  The
    kernel's launches are counted here (``launches``)."""
    nll = cross_entropy_rows(hidden, lm_head, labels)
    if lm_head.dim() == 3:
        groups = lm_head.shape[0]
    if groups is None:
        n = (labels >= 0).sum().clamp(min=1)
        return nll.sum() / n, n
    n = (labels >= 0).reshape(groups, -1).sum(1).clamp(min=1)
    return nll.reshape(groups, -1).sum(1) / n, n


chunked_cross_entropy.launches = 0
