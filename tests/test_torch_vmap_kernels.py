"""The kernel ops under ``torch.func`` (PyTorch port, CPU).

The stacked FeDepth path vmaps the loss over a client axis and takes
every client's gradient at once (plain autograd of the summed losses;
``vmap(grad(loss))``, the reference's form, gives the same), so each of
the four differentiable ops of ``repro_torch.kernels.ops`` (attention
K2, cross-entropy K1, the mamba2 K3 and rwkv6 K4 scans) must compose
with ``torch.func``.  On the CPU the ops take their kernels'
plain versions; the vmap rules and the grouped plain versions are the
same code paths the card's grouped launches take.  For each op:

- ``torch.func.grad`` equals the autograd gradient (1e-6);
- ``vmap`` over C = 3 clients, of the loss and of its gradient, equals a
  loop over the clients (1e-6): with per-client parameters, and with
  ``None`` in_dims (a parameter, or K2's keys and values, shared); and
  so does the stacked path's step, plain autograd of the vmapped loss;
- the grouped plain versions (a (G, ...) head, ``A`` / ``D`` or ``u``)
  equal a loop over the groups;
- the rewritten backwards (``torch.func.vjp`` of the plain chunks) equal
  the former ones (``requires_grad_`` + ``torch.autograd.grad``, kept
  below) at the ragged Tq = T = 600 of fault 1: chunks of 512 and 88.

Float64 inputs (the plain versions compute in float64 for them) except
the CE, whose backward computes in fp32.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401

C = 3          # clients
TOL = 1e-6
F64 = torch.float64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(gen, *shape, dtype=F64):
    return torch.randn(*shape, generator=gen, dtype=dtype)


# --------------------------------------------------------------------------
# each op: (loss of one client's inputs, one client's inputs with a
# leading client axis, the indices of its per-head parameters)
# --------------------------------------------------------------------------
def _attention_case(seed=0, *, Tq=7, Tk=7, causal=True, window=0,
                    q_offset=0):
    g = _gen(seed)
    B, Hq, Hkv, D = 2, 4, 2, 8
    args = (_randn(g, C, B, Tq, Hq, D), _randn(g, C, B, Tk, Hkv, D),
            _randn(g, C, B, Tk, Hkv, D))
    wy = _randn(g, B, Tq, Hq, D)

    def loss(q, k, v):
        out = ops.attention(q, k, v, causal=causal, sliding_window=window,
                            q_offset=q_offset)
        return (out * wy).sum()

    return loss, args, (1, 2)


def _ce_case(seed=0, *, tied=False):
    g = _gen(seed)
    B, T, D, V = 2, 6, 8, 13
    hidden = _randn(g, C, B, T, D, dtype=torch.float32)
    head = _randn(g, C, V, D, dtype=torch.float32) if tied else \
        _randn(g, C, D, V, dtype=torch.float32)
    labels = torch.randint(0, V, (C, B, T), generator=g)
    labels[:, 0, ::3] = -100           # ignored labels, per client
    labels[1, 1, :] = -100

    def loss(h, w, lbl):
        mean, _ = ops.cross_entropy(h, w.T if tied else w, lbl)
        return mean

    return loss, (hidden, head, labels), (1,)


def _mamba2_case(seed=0, *, T=9, with_state=False):
    g = _gen(seed)
    B, H, P, N = 2, 3, 4, 5
    x = _randn(g, C, B, T, H, P)
    dt = torch.nn.functional.softplus(_randn(g, C, B, T, H))
    A = -torch.exp(_randn(g, C, H))
    Bm, Cm = _randn(g, C, B, T, N), _randn(g, C, B, T, N)
    Dd = _randn(g, C, H)
    wy, ws = _randn(g, B, T, H, P), _randn(g, B, H, P, N)
    args = [x, dt, A, Bm, Cm, Dd]
    if with_state:
        args.append(_randn(g, C, B, H, P, N))

    def loss(x, dt, A, Bm, Cm, D, s0=None):
        y, s = ops.mamba2(x, dt, A, Bm, Cm, D, s0)
        return (y * wy).sum() + (s * ws).sum()

    return loss, tuple(args), (2, 5)


def _rwkv6_case(seed=0, *, T=9, with_state=False):
    g = _gen(seed)
    B, H, D = 2, 3, 4
    r, k, v = (_randn(g, C, B, T, H, D) for _ in range(3))
    w = _randn(g, C, B, T, H, D) * 0.5 - 0.5
    u = _randn(g, C, H, D) * 0.1
    wy, ws = _randn(g, B, T, H, D), _randn(g, B, H, D, D)
    args = [r, k, v, w, u]
    if with_state:
        args.append(_randn(g, C, B, H, D, D))

    def loss(r, k, v, w, u, s0=None):
        y, s = ops.rwkv6(r, k, v, w, u, s0)
        return (y * wy).sum() + (s * ws).sum()

    return loss, tuple(args), (4,)


CASES = {
    "attention": _attention_case,
    "attention-window-offset": lambda: _attention_case(
        1, Tq=5, Tk=11, window=4, q_offset=6),
    "attention-cross": lambda: _attention_case(2, Tq=5, Tk=9, causal=False),
    "cross_entropy": _ce_case,
    "cross_entropy-tied": lambda: _ce_case(3, tied=True),
    "mamba2": _mamba2_case,
    "mamba2-state": lambda: _mamba2_case(4, with_state=True),
    "rwkv6": _rwkv6_case,
    "rwkv6-state": lambda: _rwkv6_case(5, with_state=True),
}


def _float_args(args):
    return tuple(i for i, a in enumerate(args) if a.is_floating_point())


def _close(a, b, what):
    err = float((a - b).abs().max())
    assert err <= TOL, f"{what}: {err}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_func_grad_equals_autograd(case):
    loss, args, _ = CASES[case]()
    one = [a[0] for a in args]
    idx = _float_args(one)
    grads = torch.func.grad(loss, argnums=idx)(*one)
    leaves = [t.clone().requires_grad_() if i in idx else t
              for i, t in enumerate(one)]
    expect = torch.autograd.grad(loss(*leaves), [leaves[i] for i in idx])
    for i, a, b in zip(idx, grads, expect):
        _close(a, b, f"{case} d arg {i}")


@pytest.mark.parametrize("shared", [False, True], ids=["per-client",
                                                       "shared"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vmap_equals_loop_over_clients(case, shared):
    """``vmap`` of the loss and of ``grad(loss)`` over 3 clients equals
    the loop; ``shared`` passes the per-head parameters (K2: the keys and
    values) unbatched, client 0's for every client."""
    loss, args, params = CASES[case]()
    in_dims = tuple(None if shared and i in params else 0
                    for i in range(len(args)))
    args = tuple(a[0] if d is None else a for a, d in zip(args, in_dims))
    idx = _float_args(args)
    values = torch.func.vmap(loss, in_dims=in_dims)(*args)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=idx),
                            in_dims=in_dims)(*args)
    for c in range(C):
        one = [a if d is None else a[c] for a, d in zip(args, in_dims)]
        _close(values[c], loss(*one), f"{case} loss of client {c}")
        leaves = [t.clone().requires_grad_() if i in idx else t
                  for i, t in enumerate(one)]
        expect = torch.autograd.grad(loss(*leaves),
                                     [leaves[i] for i in idx])
        for i, a, b in zip(idx, grads, expect):
            _close(a[c], b, f"{case} d arg {i} of client {c}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_grads_equal_loop_over_clients(case):
    """The stacked path's step (``blockwise.stacked_grads``): the loss
    vmapped over the clients and plain autograd of the summed losses.
    The vmap rules call the Functions' own ``apply`` on the folded,
    grouped tensors, so autograd runs the grouped backwards; each
    client's slice equals its own gradient (1e-6)."""
    from repro_torch.core.blockwise import stacked_grads
    loss, args, _ = CASES[case]()
    idx = _float_args(args)

    def stacked_loss(train, *rest):
        full = list(rest)
        for i, t in zip(idx, train):
            full.insert(i, t)
        return loss(*full)

    rest = [a for i, a in enumerate(args) if i not in idx]
    grads = stacked_grads(stacked_loss, in_dims=0)(
        [args[i].clone() for i in idx], *rest)
    for c in range(C):
        leaves = [a[c].clone().requires_grad_() if i in idx else a[c]
                  for i, a in enumerate(args)]
        expect = torch.autograd.grad(loss(*leaves),
                                     [leaves[i] for i in idx])
        for i, a, b in zip(idx, grads, expect):
            _close(a[c], b, f"{case} d arg {i} of client {c}")


def test_cross_entropy_vmap_means_per_client():
    """K1's vmap rule returns each client's own (mean over its valid
    tokens, n_valid), as ``jax.vmap`` of the reference's
    ``chunked_cross_entropy`` gives them: client 1 has a whole row
    ignored, so the clients' counts differ."""
    _, (h, w, lbl), _ = _ce_case()
    means, n = torch.func.vmap(ops.cross_entropy)(h, w, lbl)
    for c in range(C):
        m, nc = ref.cross_entropy_logits(h[c], w[c], lbl[c])
        assert int(n[c]) == int(nc)
        _close(means[c], m, f"client {c}")
    assert len({int(x) for x in n}) > 1


@pytest.mark.parametrize("groups", [1, 3])
def test_grouped_plain_versions_equal_a_loop_over_groups(groups):
    """Batch rows [g·B/G, (g+1)·B/G) read group g's head, ``A`` / ``D``
    or ``u``; an ungrouped parameter is shared."""
    g = _gen(7)
    Bg, T = 2, 6
    B = groups * Bg
    rows = [slice(i * Bg, (i + 1) * Bg) for i in range(groups)]
    # K1: a (G, D, V) head and a tied (G, V, D) table read as (G, D, V)
    D, V = 8, 13
    h = _randn(g, B, T, D)
    lbl = torch.randint(0, V, (B, T), generator=g)
    lbl[:, ::4] = -100
    for head in (_randn(g, groups, D, V),
                 _randn(g, groups, V, D).transpose(1, 2)):
        got = ref.cross_entropy_rows(h, head, lbl).reshape(B, T)
        for i, r in enumerate(rows):
            _close(got[r], ref.cross_entropy_rows(h[r], head[i], lbl[r])
                   .reshape(Bg, T), f"K1 group {i}")
    # K3: (G, H) A and D, both the sequential and the chunked form
    H, P, N = 3, 4, 5
    x, Bm, Cm = _randn(g, B, T, H, P), _randn(g, B, T, N), _randn(g, B, T, N)
    dt = torch.nn.functional.softplus(_randn(g, B, T, H))
    A, Dd = -torch.exp(_randn(g, groups, H)), _randn(g, groups, H)
    s0 = _randn(g, B, H, P, N)
    for fn in (ref.mamba2_scan, ref.mamba2_scan_chunked):
        y, s = fn(x, dt, A, Bm, Cm, Dd, s0)
        for i, r in enumerate(rows):
            yi, si = fn(x[r], dt[r], A[i], Bm[r], Cm[r], Dd[i], s0[r])
            _close(y[r], yi, f"K3 {fn.__name__} y, group {i}")
            _close(s[r], si.to(s.dtype), f"K3 {fn.__name__} state, group {i}")
    # K4: a (G, H, D) u
    Dh = 4
    r_, k, v = (_randn(g, B, T, H, Dh) for _ in range(3))
    w = _randn(g, B, T, H, Dh) * 0.5 - 0.5
    u = _randn(g, groups, H, Dh)
    y, s = ref.rwkv6_scan(r_, k, v, w, u)
    for i, r in enumerate(rows):
        yi, si = ref.rwkv6_scan(r_[r], k[r], v[r], w[r], u[i])
        _close(y[r], yi, f"K4 y, group {i}")
        _close(s[r], si, f"K4 state, group {i}")


# --------------------------------------------------------------------------
# the former backwards (autograd.grad over detached leaves), to hold the
# rewritten ones to at the ragged Tq = T = 600
# --------------------------------------------------------------------------
def _former_attention_bwd(q, k, v, g, causal, sliding_window, q_offset,
                          scale):
    Tq = q.shape[1]
    cq = min(ops.ATTN_BWD_Q_CHUNK, Tq)
    dqs = []
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    with torch.enable_grad():
        kd = k.detach().requires_grad_()
        vd = v.detach().requires_grad_()
        for start in range(0, Tq, cq):
            qs = q[:, start:start + cq].detach().requires_grad_()
            out = ref.attention(qs, kd, vd, causal=causal,
                                sliding_window=sliding_window,
                                q_offset=q_offset + start, scale=scale)
            dq_i, dk_i, dv_i = torch.autograd.grad(
                out, (qs, kd, vd), g[:, start:start + cq])
            dqs.append(dq_i)
            dk += dk_i
            dv += dv_i
    return torch.cat(dqs, dim=1), dk, dv


def _former_scan_chunk_bwd(scan_fn, seq_args, bcast_args, s0, gy, gs,
                           chunk):
    T = seq_args[0].shape[1]
    bounds = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
    entry = [s0]
    with torch.no_grad():
        for lo, hi in bounds[:-1]:
            _, s = scan_fn(*(a[:, lo:hi] for a in seq_args), *bcast_args,
                           entry[-1])
            entry.append(s)
    dseq = [[] for _ in seq_args]
    dbcast = [torch.zeros_like(b) for b in bcast_args]
    ds = gs
    with torch.enable_grad():
        bcast = [b.detach().requires_grad_() for b in bcast_args]
        for idx in reversed(range(len(bounds))):
            lo, hi = bounds[idx]
            seq = [a[:, lo:hi].detach().requires_grad_() for a in seq_args]
            s_in = entry[idx].detach().requires_grad_()
            y, s_out = scan_fn(*seq, *bcast, s_in)
            grads = torch.autograd.grad((y, s_out), (*seq, *bcast, s_in),
                                        (gy[:, lo:hi], ds),
                                        allow_unused=True)
            for i, g in enumerate(grads[:len(seq)]):
                dseq[i].append(torch.zeros_like(seq[i]) if g is None else g)
            for i, g in enumerate(grads[len(seq):-1]):
                if g is not None:
                    dbcast[i] += g
            ds = grads[-1]
    return ([torch.cat(parts[::-1], dim=1) for parts in dseq], dbcast, ds)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


@pytest.mark.parametrize("op", ["attention", "mamba2", "rwkv6"])
def test_rewritten_backward_equals_former_at_ragged_600(op):
    """fp32, T = 600 over chunks of 512: the last chunk is the ragged 88
    (fault 1).  Bitwise up to the sum's first term (0 + x = x)."""
    g = _gen(11)
    T = 600

    def rn(*shape):
        return torch.randn(*shape, generator=g)

    if op == "attention":
        q, k, v, gy = rn(1, T, 4, 8), rn(1, T, 2, 8), rn(1, T, 2, 8), \
            rn(1, T, 4, 8)
        opts = (True, 100, 0, None)
        got = ops.attention_bwd(q, k, v, gy, *opts)
        want = _former_attention_bwd(q, k, v, gy, *opts)
    elif op == "mamba2":
        H, P, N = 2, 4, 3
        x, Bm, Cm = rn(1, T, H, P), rn(1, T, N), rn(1, T, N)
        dt = torch.nn.functional.softplus(rn(1, T, H))
        A, Dd, s0 = -torch.exp(rn(H)), rn(H), rn(1, H, P, N)
        gy, gs = rn(1, T, H, P), rn(1, H, P, N)
        seq, bc = (x, dt, Bm, Cm), (A, Dd)
        got = ops.scan_chunk_bwd(ops._mamba2_recompute, seq, bc, s0, gy, gs)
        want = _former_scan_chunk_bwd(ops._mamba2_recompute, seq, bc, s0,
                                      gy, gs, ops.SCAN_BWD_CHUNK)
    else:
        H, D = 2, 4
        r, k, v = rn(1, T, H, D), rn(1, T, H, D), rn(1, T, H, D)
        w, u, s0 = rn(1, T, H, D) * 0.5 - 0.5, rn(H, D) * 0.1, \
            rn(1, H, D, D)
        gy, gs = rn(1, T, H, D), rn(1, H, D, D)
        seq, bc = (r, k, v, w), (u,)
        got = ops.scan_chunk_bwd(ref.rwkv6_scan, seq, bc, s0, gy, gs)
        want = _former_scan_chunk_bwd(ref.rwkv6_scan, seq, bc, s0, gy, gs,
                                      ops.SCAN_BWD_CHUNK)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), f"{op} gradient {i}: " \
            f"{float((a - b).abs().max())}"
