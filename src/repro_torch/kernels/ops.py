"""Public kernel ops: device dispatch + differentiable wrappers.

Models call these, never the kernels directly.  Dispatch follows the
tensors: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain version (``kernels/ref.py``) — there is no fallback from one
to the other.  Each op is a ``torch.autograd.Function`` whose forward is
the kernel and whose backward recomputes in plain PyTorch with the
reference's chunking (``repro.kernels.ops._fa_bwd`` / ``_ce_bwd`` /
``_scan_chunk_bwd``): it saves only the inputs and none of the kernel's
intermediates, so live memory is one chunk, not (Tq x Tk), (B*T x V) or a
whole sequence of scan states.

The Functions compose with ``torch.func`` (the stacked FeDepth path runs
``vmap(grad(loss))`` over a client axis).  They take the
``setup_context`` form; the backwards are ``torch.func.vjp`` of the plain
chunk functions and explicit formulas, never ``requires_grad_`` and
``torch.autograd.grad``, which a functorch transform refuses.  Each has a
``vmap`` rule, as ``jax.vmap`` batches a ``pallas_call`` by adding a grid
axis: one launch covers every client.  K2 folds the clients into its
batch axis; K1, K3 and K4, whose parameters (the head, ``A`` / ``D``,
``u``) differ per client, launch their grouped kernels: batch rows
``[c·B, (c+1)·B)`` read client c's parameters.  An input that is not
batched (``in_dims`` None) is shared by every client.  A rule calls the
Function's own ``apply`` on the folded, grouped tensors, so a vmapped
forward differentiated by plain autograd (the stacked path's step) runs
the grouped backward: the scans' plain versions and the CE's formulas
take the grouped parameters as they are.

**The sharded route.**  A public op given DTensors (parameters laid out
by ``launch.sharding`` on a ``DeviceMesh``) runs its kernel on each
rank's local shards through ``local_map``: K2 over batch and heads (GQA
kv heads left whole are sliced per rank), K3 and K4 over batch and heads,
K1 over rows and, for a head split over the vocab, over the vocab: each
rank's kernel gives its shard's log-sum-exp and gold logit, which an
all-reduce combines.  Where the placements do not make the work local (a
sequence split, heads that do not divide the axis, an FSDP split of the
head's contracted dim), the operands are first gathered on those mesh
dims, at one named line (``_laid_out``); no op is left to DTensor's
propagation, and no DTensor reaches a plain version.  A mesh dim of size
1 splits nothing.  A ``meta`` tensor (the dry run's) takes the plain
version, as a CPU tensor does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dtensor import is_dtensor
from repro_torch.kernels import ref
from repro_torch.kernels.chunked_ce import (chunked_cross_entropy,
                                            cross_entropy_lse_gold)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

# the reference's backward chunks: q rows of 4 * block_q at the Pallas
# default block_q=128 (ops.py:_fa_bwd), tokens of 2048 (_ce_chunked_jnp),
# time steps of 4 * block_t at the default block_t=128 (_rwkv_bwd, _ssd_bwd)
ATTN_BWD_Q_CHUNK = 4 * 128
CE_CHUNK = 2048
SCAN_BWD_CHUNK = 4 * 128


# --------------------------------------------------------------------------
# vmap rules: the client axis
# --------------------------------------------------------------------------
def _clients_first(t: torch.Tensor, in_dim: Optional[int], C: int):
    """``t`` with its client axis first: moved there, or ``t`` broadcast
    to every client when it is not batched."""
    if in_dim is None:
        return t.expand(C, *t.shape)
    return t.movedim(in_dim, 0)


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(C, B, ...) -> (C·B, ...), contiguous: the kernels' batch axis."""
    return t.reshape(-1, *t.shape[2:]).contiguous()


def _unfold(t: torch.Tensor, C: int) -> torch.Tensor:
    return t.reshape(C, -1, *t.shape[1:])


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, sliding_window, q_offset, scale):
        return flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               q_offset=q_offset, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *opts = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = tuple(opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g, *ctx.opts)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sliding_window, q_offset,
             scale):
        """The clients fold into the batch axis: one launch, each batch
        row attending over its own keys with one client's mask and
        offset (a shared k / v, whisper's cross-attention over one
        encoder output, is broadcast first)."""
        C = info.batch_size
        q, k, v = (_clients_first(t, d, C)
                   for t, d in zip((q, k, v), in_dims[:3]))
        out = FlashAttention.apply(_fold(q), _fold(k), _fold(v), causal,
                                   sliding_window, q_offset, scale)
        return _unfold(out, C), 0


def attention_bwd(q, k, v, g, causal, sliding_window, q_offset, scale):
    """Recompute-based backward over q chunks: live memory is one chunk's
    (chunk x Tk) scores.  The last chunk is the ragged remainder (the
    reference slices a fixed-size window instead — see ROADMAP.md queue
    3).  Each chunk is ``torch.func.vjp`` of the plain attention, so the
    backward runs under ``vmap`` too; the key and value gradients are
    summed out of place (a shared k's zero buffer would not take a
    batched gradient in place)."""
    Tq = q.shape[1]
    cq = min(ATTN_BWD_Q_CHUNK, Tq)
    dqs, dk, dv = [], None, None
    for start in range(0, Tq, cq):
        def chunk(qs, ks, vs, start=start):
            return ref.attention(qs, ks, vs, causal=causal,
                                 sliding_window=sliding_window,
                                 q_offset=q_offset + start, scale=scale)

        _, pull = torch.func.vjp(chunk, q[:, start:start + cq], k, v)
        dq_i, dk_i, dv_i = pull(g[:, start:start + cq])
        dqs.append(dq_i)
        dk = dk_i if dk is None else dk + dk_i
        dv = dv_i if dv is None else dv + dv_i
    return torch.cat(dqs, dim=1), dk, dv


def attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
              q_offset: int = 0, scale: Optional[float] = None):
    """Differentiable GQA attention (see ``kernels/flash_attention.py``)."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal, sliding_window, q_offset,
                                  scale)
    return FlashAttention.apply(q, k, v, causal, sliding_window, q_offset,
                                scale)


# --------------------------------------------------------------------------
# cross-entropy over a large vocab
# --------------------------------------------------------------------------
class ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(hidden, lm_head, labels, groups):
        return chunked_cross_entropy(hidden, lm_head, labels, groups=groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, lm_head, labels, ctx.groups = inputs
        ctx.save_for_backward(hidden, lm_head, labels)
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, gloss, _gn):
        hidden, lm_head, labels = ctx.saved_tensors
        dh, dw = cross_entropy_bwd(hidden, lm_head, labels, gloss,
                                   groups=ctx.groups)
        return dh, dw, None, None

    @staticmethod
    def vmap(info, in_dims, hidden, lm_head, labels, groups):
        """One grouped launch: client c's rows multiply client c's head
        (a tied head arrives as a (C, D, V) view of the (C, V, D) table,
        read in place), and each client gets its own (mean over its valid
        tokens, n_valid), as ``jax.vmap`` of the reference gives them.  A
        head no client owns is shared: one (D, V) head, one group."""
        C = info.batch_size
        h = _clients_first(hidden, in_dims[0], C)
        lbl = _clients_first(labels, in_dims[2], C)
        head = (lm_head if in_dims[1] is None
                else lm_head.movedim(in_dims[1], 0))
        return ChunkedCrossEntropy.apply(_fold(h), head, _fold(lbl),
                                         C), (0, 0)


def cross_entropy_bwd(hidden, lm_head, labels, gloss, chunk: int = CE_CHUNK,
                      groups: Optional[int] = None):
    """Gradient of the chunked mean NLL, recomputed over token chunks:
    per chunk, d(loss)/d(logits) = valid * (softmax - onehot) * g / n, then
    one product each for d hidden and d lm_head.  Only one chunk's logits
    are ever live.  A (G, D, V) head, or ``groups`` G over a shared (D, V)
    one, splits the rows into G groups with a mean each (``gloss`` (G,)):
    the stacked path's clients, each chunk G x ``chunk`` rows.  Explicit
    formulas, so that it also runs under ``vmap`` as it is."""
    G = lm_head.shape[0] if lm_head.dim() == 3 else (groups or 1)
    D = hidden.shape[-1]
    h = hidden.reshape(G, -1, D).float()
    lbl = labels.reshape(G, -1)
    w = lm_head.float()
    valid = lbl >= 0
    coef = valid.float() * (gloss.float().reshape(-1, 1)
                            / valid.sum(1, keepdim=True).clamp(min=1))
    dh, dw = [], None
    for s in range(0, h.shape[1], chunk):
        hs = h[:, s:s + chunk]
        p = torch.softmax(hs @ w, dim=-1)                  # (G, rows, V)
        flat = p.view(-1, p.shape[-1])
        flat[torch.arange(flat.shape[0], device=p.device),
             lbl[:, s:s + chunk].reshape(-1).clamp(min=0).long()] -= 1.0
        p *= coef[:, s:s + chunk, None]
        dh.append(p @ w.transpose(-1, -2))
        # a shared head's gradient sums every group's rows: one product;
        # out of place, since under vmap it may be batched
        dw_s = (hs.transpose(1, 2) @ p if w.dim() == 3
                else hs.reshape(-1, D).T @ flat)
        dw = dw_s if dw is None else dw + dw_s
    return (torch.cat(dh, 1).reshape(hidden.shape).to(hidden.dtype),
            dw.to(lm_head.dtype))


def cross_entropy(hidden, lm_head, labels
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mean NLL over valid labels, n_valid) of
    ``hidden @ lm_head`` (see ``kernels/chunked_ce.py``)."""
    if is_dtensor(hidden):
        return _sharded_cross_entropy(hidden, lm_head, labels)
    return ChunkedCrossEntropy.apply(hidden, lm_head, labels, None)


# --------------------------------------------------------------------------
# linear-state scans (mamba2 SSD, rwkv6 WKV)
# --------------------------------------------------------------------------
def scan_chunk_bwd(scan_fn, seq_args, bcast_args, s0, gy, gs,
                   chunk: int = SCAN_BWD_CHUNK):
    """Gradient of a linear-state scan by chunked recompute (port of
    ``repro.kernels.ops._scan_chunk_bwd``).

    ``scan_fn(*seq_chunks, *bcast, state) -> (y_chunk, state_out)`` must
    chain exactly across time chunks.  Pass 1 recomputes only the
    chunk-entry states; pass 2 walks the chunks in reverse, differentiating
    one chunk at a time (``torch.func.vjp``, so that it runs under
    ``vmap`` too) with the state cotangent chained backward, so live
    memory is one chunk's activations.  Returns (d seq_args, d bcast_args
    summed over chunks, d s0)."""
    T = seq_args[0].shape[1]
    bounds = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
    entry = [s0]
    with torch.no_grad():
        for lo, hi in bounds[:-1]:
            _, s = scan_fn(*(a[:, lo:hi] for a in seq_args), *bcast_args,
                           entry[-1])
            entry.append(s)
    n_seq = len(seq_args)
    dseq = [[] for _ in seq_args]
    dbcast = [None] * len(bcast_args)
    ds = gs
    for idx in reversed(range(len(bounds))):
        lo, hi = bounds[idx]
        _, pull = torch.func.vjp(scan_fn, *(a[:, lo:hi] for a in seq_args),
                                 *bcast_args, entry[idx])
        grads = pull((gy[:, lo:hi], ds))
        for i, g in enumerate(grads[:n_seq]):
            dseq[i].append(g)
        # out of place: a shared parameter's gradient is batched under vmap
        for i, g in enumerate(grads[n_seq:-1]):
            dbcast[i] = g if dbcast[i] is None else dbcast[i] + g
        ds = grads[-1]
    return ([torch.cat(parts[::-1], dim=1) for parts in dseq], dbcast, ds)


def _mamba2_recompute(x, dt, Bm, Cm, A, D, s):
    return ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, s)


def _scan_vmap(apply, info, seq, params, s0):
    """The scans' vmap rule: the clients fold into the batch axis, and a
    per-client parameter makes the launch grouped (one group a client);
    a parameter no client owns stays shared.  ``seq`` and ``params`` are
    (tensor, in_dim) pairs; a state that is not batched (``new_zeros``
    in ``mamba2`` / ``rwkv6``) is broadcast.  ``apply`` is the Function's
    own, so that autograd records the grouped call when the vmapped
    forward is differentiated from outside."""
    C = info.batch_size
    shared = all(d is None for _, d in params)
    seq = [_fold(_clients_first(t, d, C)) for t, d in seq]
    params = [t if shared else _clients_first(t, d, C).contiguous()
              for t, d in params]
    y, state = apply(*seq, *params, _fold(_clients_first(*s0, C)))
    return (_unfold(y, C), _unfold(state, C)), (0, 0)


class Mamba2Scan(torch.autograd.Function):
    @staticmethod
    def forward(x, dt, A, Bm, Cm, D, s0):
        return mamba2_scan(x, dt, A, Bm, Cm, D, s0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gs):
        """The reference's chunked recompute (``ops.py:_ssd_bwd``), each
        chunk in the SSD chunked form (float64) rather than a T-step
        loop, which would be launch-bound on the card."""
        x, dt, A, Bm, Cm, D, s0 = ctx.saved_tensors
        (dx, ddt, dB, dC), (dA, dD), ds = scan_chunk_bwd(
            _mamba2_recompute, (x, dt, Bm, Cm), (A, D), s0, gy, gs,
            min(SCAN_BWD_CHUNK, x.shape[1]))
        return dx, ddt, dA, dB, dC, dD, ds

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, D, s0):
        dx, ddt, dA, dB, dC, dD, ds = in_dims
        return _scan_vmap(
            lambda x, dt, Bm, Cm, A, D, s: Mamba2Scan.apply(x, dt, A, Bm, Cm,
                                                            D, s),
            info, ((x, dx), (dt, ddt), (Bm, dB), (Cm, dC)),
            ((A, dA), (D, dD)), (s0, ds))


def mamba2(x, dt, A, Bm, Cm, D, initial_state=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable Mamba2 SSD scan -> (y (B,T,H,P), final state
    (B,H,P,N)) (see ``kernels/mamba2_ssd.py``)."""
    if is_dtensor(x):
        return _sharded_scan(_mamba2_local, (x, dt, A, Bm, Cm, D),
                             _MAMBA2_ROLES, initial_state)
    if initial_state is None:
        B, _, H, P = x.shape
        initial_state = x.new_zeros(B, H, P, Bm.shape[-1],
                                    dtype=torch.float32)
    return Mamba2Scan.apply(*(t.contiguous() for t in
                              (x, dt, A, Bm, Cm, D, initial_state)))


class Rwkv6Scan(torch.autograd.Function):
    @staticmethod
    def forward(r, k, v, w, u, s0):
        return rwkv6_scan(r, k, v, w, u, s0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gs):
        """The reference's chunked recompute (``ops.py:_rwkv_bwd``) through
        the sequential plain scan: the per-channel decay makes the chunked
        matmul form unsafe."""
        r, k, v, w, u, s0 = ctx.saved_tensors
        (dr, dk, dv, dw), (du,), ds = scan_chunk_bwd(
            ref.rwkv6_scan, (r, k, v, w), (u,), s0, gy, gs,
            min(SCAN_BWD_CHUNK, r.shape[1]))
        return dr, dk, dv, dw, du, ds

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0):
        return _scan_vmap(
            Rwkv6Scan.apply, info, tuple(zip((r, k, v, w), in_dims[:4])),
            ((u, in_dims[4]),), (s0, in_dims[5]))


def rwkv6(r, k, v, w, u, initial_state=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable RWKV6 WKV scan -> (y (B,T,H,D), final state
    (B,H,D,D)) (see ``kernels/rwkv6_scan.py``)."""
    if is_dtensor(r):
        return _sharded_scan(_rwkv6_local, (r, k, v, w, u), _RWKV6_ROLES,
                             initial_state)
    if initial_state is None:
        B, _, H, D = r.shape
        initial_state = r.new_zeros(B, H, D, D, dtype=torch.float32)
    return Rwkv6Scan.apply(*(t.contiguous() for t in
                             (r, k, v, w, u, initial_state)))


# --------------------------------------------------------------------------
# the sharded route: DTensor operands
# --------------------------------------------------------------------------
def _local_map(fn, out_placements, in_placements, grad_placements, mesh):
    """``local_map`` with each tensor's placements as a list (a tuple
    would read as one entry per output) and None for a non-tensor."""
    from torch.distributed.tensor.experimental import local_map

    def lists(pls):
        return tuple(None if p is None else list(p) for p in pls)
    return local_map(fn, out_placements=lists(out_placements),
                     in_placements=lists(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else lists(grad_placements)),
                     device_mesh=mesh)


def _shards(t, i: int, d: int) -> bool:
    """Whether DTensor ``t`` splits tensor dim ``d`` evenly on mesh dim
    ``i`` (evenly over every mesh dim that splits ``d``)."""
    from torch.distributed.tensor import Shard
    pl, mesh = t.placements[i], t.device_mesh
    if not (isinstance(pl, Shard) and pl.dim % t.dim() == d % t.dim()):
        return False
    ways = 1
    for j, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim % t.dim() == d % t.dim():
            ways *= mesh.size(j)
    return t.shape[d] % ways == 0


def _plan(args, roles):
    """Where the work splits into local pieces, and the layout that makes
    it so.  ``roles`` gives, for each argument, the tensor dim of each
    role (None where the argument lacks it: a parameter has no batch,
    ``Bm`` is shared by every head).  A mesh dim of size > 1 takes the
    first role that every argument having it splits evenly there; an
    argument lacking that role must be whole there, and every argument is
    whole on a mesh dim that takes no role.  Returns ({mesh dim: role},
    the placements each argument needs: its own wherever the work is
    already local)."""
    from torch.distributed.tensor import Replicate
    mesh = args[0].device_mesh
    for t in args:
        if t is not None and (not is_dtensor(t) or t.device_mesh != mesh):
            raise TypeError("the sharded route needs every operand a "
                            "DTensor on one mesh")
    by_mesh = {}
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            continue
        for role in roles[0]:
            have = [(t, rl[role]) for t, rl in zip(args, roles)
                    if t is not None and rl[role] is not None]
            if have and all(_shards(t, i, d) for t, d in have):
                by_mesh[i] = role
                break
    want = []
    for t, rl in zip(args, roles):
        if t is None:
            want.append(None)
            continue
        want.append(tuple(
            p if mesh.size(i) == 1 or (i in by_mesh
                                       and rl[by_mesh[i]] is not None)
            else Replicate() for i, p in enumerate(t.placements)))
    return by_mesh, want


def _is_laid_out(args, want) -> bool:
    return all(t is None or tuple(t.placements) == w
               for t, w in zip(args, want))


def _laid_out(args, want):
    """The arguments in the layout ``want``: the sharded route's one
    redistribution, a gather on each mesh dim where the work is not
    local (a sequence split, heads that do not divide the axis, an FSDP
    split of a weight's contracted dim), so that the kernel still runs on
    each rank's pieces and no op is left to DTensor's propagation."""
    return tuple(t if t is None or tuple(t.placements) == w
                 else t.redistribute(t.device_mesh, w)
                 for t, w in zip(args, want))


def _grad_placements(t, by_mesh, role_dims):
    """A local gradient's placements: the argument's own, except a pending
    sum on each mesh dim whose role the argument lacks (every rank's
    gradient of a shared operand is a share of the whole)."""
    if t is None:
        return None
    from torch.distributed.tensor import Partial
    out = list(t.placements)
    for i, role in by_mesh.items():
        if role_dims[role] is None:
            out[i] = Partial()
    return tuple(out)


def _placements(t):
    return None if t is None else tuple(t.placements)


_ATTN_ROLES = ({"batch": 0, "heads": 2},) * 3
# q heads split, kv heads whole (fewer kv heads than the axis splits)
_ATTN_KV_WHOLE = ({"batch": 0, "heads": 2}, {"batch": 0, "heads": None},
                  {"batch": 0, "heads": None})


def _kv_slice(q, k, v):
    """For q heads split on one mesh dim and kv heads whole there: (that
    mesh dim, the function from a rank's coordinate on it to the [lo, hi)
    of the kv heads its q heads read, {mesh dim: role}), when each rank's
    q heads fill whole kv groups or lie in one; else None."""
    by_mesh, want = _plan((q, k, v), _ATTN_KV_WHOLE)
    heads = [i for i, r in by_mesh.items() if r == "heads"]
    if not _is_laid_out((q, k, v), want) or len(heads) != 1:
        return None
    i = heads[0]
    hq_loc = q.shape[2] // q.device_mesh.size(i)
    rep = q.shape[2] // k.shape[2]
    if hq_loc % rep and rep % hq_loc:
        return None
    return i, lambda r: (r * hq_loc // rep,
                         (r * hq_loc + hq_loc - 1) // rep + 1), by_mesh


def _sharded_attention(q, k, v, causal, sliding_window, q_offset, scale):
    """K2 on each rank's batch rows and heads: kv heads split with their
    q heads (a local q head reads its local kv head), or left whole and
    each rank slicing the kv heads its q heads read (GQA with fewer kv
    heads than the axis splits); else on the layout :func:`_plan` gives
    (gathered on the mesh dims that split neither)."""
    def run(ql, kl, vl):
        return FlashAttention.apply(ql, kl, vl, causal, sliding_window,
                                    q_offset, scale)

    mesh = q.device_mesh
    by_mesh, want = _plan((q, k, v), _ATTN_ROLES)
    kv = None if _is_laid_out((q, k, v), want) else _kv_slice(q, k, v)
    if kv is None:
        return _local_map(run, (want[0],), want, None, mesh)(
            *_laid_out((q, k, v), want))
    i, span, by_mesh = kv

    def local(ql, kl, vl):
        lo, hi = span(mesh.get_local_rank(i))
        return run(ql, kl[:, :, lo:hi].contiguous(),
                   vl[:, :, lo:hi].contiguous())
    grads = (q.placements,) + tuple(
        _grad_placements(t, by_mesh, _ATTN_KV_WHOLE[1]) for t in (k, v))
    return _local_map(local, (q.placements,),
                      tuple(map(_placements, (q, k, v))), grads,
                      mesh)(q, k, v)


class VocabShardCrossEntropy(torch.autograd.Function):
    """K1 on one rank's vocab shard [v0, v0 + V_loc) of a head split over
    the vocab on the mesh dims ``groups`` (local tensors, inside
    ``local_map``).  The kernel gives each row's log-sum-exp over the
    shard and its gold logit where the label lies in the shard; an
    all-reduce over ``groups`` makes them the whole vocab's (the max, then
    the sum of exp; the gold, a sum).  Returns the per-row NLL, 0 where
    the label is ignored, the same on every rank of ``groups``.  The
    backward recomputes each chunk of the shard's logits: d logits =
    (softmax over the whole vocab - onehot) * g; d hidden is this shard's
    share of a sum over the shards, d head the shard's own."""

    @staticmethod
    def forward(hidden, lm_head, labels, v0, groups):
        from torch.distributed import _functional_collectives as funcol
        V = lm_head.shape[-1]
        local = labels - v0
        here = (labels >= 0) & (local >= 0) & (local < V)
        # V: a column the shard lacks (the gold logit lies elsewhere)
        lse, gold = cross_entropy_lse_gold(hidden, lm_head,
                                           torch.where(here, local, V))
        for g in groups:
            m = funcol.all_reduce(lse, "max", g)
            lse = m + torch.log(funcol.all_reduce(torch.exp(lse - m),
                                                  "sum", g))
            gold = funcol.all_reduce(gold, "sum", g)
        return torch.where(labels.reshape(-1) >= 0, lse - gold, 0.0), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, lm_head, labels, ctx.v0, _ = inputs
        ctx.save_for_backward(hidden, lm_head, labels, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _glse):
        hidden, lm_head, labels, lse = ctx.saved_tensors
        D, V = lm_head.shape
        h = hidden.reshape(-1, D).float()
        w = lm_head.float()
        local = labels.reshape(-1).long() - ctx.v0
        hit = ((labels.reshape(-1) >= 0) & (local >= 0)
               & (local < V)).float()
        coef = g.float() * (labels.reshape(-1) >= 0).float()
        dh, dw = [], torch.zeros_like(w)
        for s in range(0, h.shape[0], CE_CHUNK):
            p = torch.exp(h[s:s + CE_CHUNK] @ w
                          - lse[s:s + CE_CHUNK, None])
            p.scatter_add_(1, local[s:s + CE_CHUNK].clamp(0, V - 1)[:, None],
                           -hit[s:s + CE_CHUNK, None])
            p *= coef[s:s + CE_CHUNK, None]
            dh.append(p @ w.T)
            dw += h[s:s + CE_CHUNK].T @ p
        return (torch.cat(dh).reshape(hidden.shape).to(hidden.dtype),
                dw.to(lm_head.dtype), None, None, None)


# (hidden, lm_head, labels): rows split the tokens, vocab the head's V
_CE_ROLES = ({"rows": 0, "vocab": None}, {"rows": None, "vocab": 1},
             {"rows": 0, "vocab": None})


def _sharded_cross_entropy(hidden, lm_head, labels):
    """K1 on each rank's rows and, for a head split over the vocab, its
    vocab shard (:class:`VocabShardCrossEntropy`), on the layout
    :func:`_plan` gives.  Each rank's loss is its share of the mean: its
    rows' NLL over the global count of valid labels (an all-reduce over
    the mesh dims that split the rows; clamped at 1, as the kernel's
    mean), a pending sum there."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = hidden.device_mesh
    by_mesh, want = _plan((hidden, lm_head, labels), _CE_ROLES)
    args = _laid_out((hidden, lm_head, labels), want)
    rows = [(mesh, i) for i, r in by_mesh.items() if r == "rows"]
    vocab = [(mesh, i) for i, r in by_mesh.items() if r == "vocab"]
    v0 = compute_local_shape_and_global_offset(
        lm_head.shape, mesh, want[1])[1][-1]

    def local(h, w, lbl):
        valid = (lbl >= 0).sum()
        n = valid
        for g in rows:
            n = funcol.all_reduce(n, "sum", g)
        n = n.clamp(min=1)
        if vocab:
            nll, _ = VocabShardCrossEntropy.apply(h, w, lbl, v0, vocab)
            return nll.sum() / n, n
        loss, _ = ChunkedCrossEntropy.apply(h, w, lbl, None)
        return loss * (valid / n), n
    out = tuple(Partial() if by_mesh.get(i) == "rows" else Replicate()
                for i in range(mesh.ndim))
    grads = tuple(_grad_placements(t, by_mesh, rl)
                  for t, rl in zip(args, _CE_ROLES))
    return _local_map(local, (out, (Replicate(),) * mesh.ndim), want,
                      grads, mesh)(*args)


# (x, dt, A, Bm, Cm, D) and the state; (r, k, v, w, u) and the state
_MAMBA2_ROLES = ({"batch": 0, "heads": 2}, {"batch": 0, "heads": 2},
                 {"batch": None, "heads": 0}, {"batch": 0, "heads": None},
                 {"batch": 0, "heads": None}, {"batch": None, "heads": 0},
                 {"batch": 0, "heads": 1})
_RWKV6_ROLES = ({"batch": 0, "heads": 2},) * 4 + (
    {"batch": None, "heads": 0}, {"batch": 0, "heads": 1})


def _mamba2_local(x, dt, A, Bm, Cm, D, s0):
    return mamba2(x, dt, A, Bm, Cm, D, s0)


def _rwkv6_local(r, k, v, w, u, s0):
    return rwkv6(r, k, v, w, u, s0)


def _sharded_scan(local, args, roles, s0):
    """K3 / K4 on each rank's batch rows and heads, on the layout
    :func:`_plan` gives (a head-shared operand whole on every rank, its
    gradient a pending sum)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = args[0].device_mesh
    by_mesh, want = _plan(args + (s0,), roles)
    state_pl = [Replicate()] * mesh.ndim
    for i, role in by_mesh.items():
        state_pl[i] = Shard(roles[-1][role])
    laid = _laid_out(args + (s0,), want)
    grads = tuple(_grad_placements(t, by_mesh, rl)
                  for t, rl in zip(laid, roles))
    return _local_map(local, (want[0], tuple(state_pl)), want, grads,
                      mesh)(*laid)
