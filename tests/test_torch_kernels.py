"""Port kernels vs the reference (PyTorch port: ``repro_torch.kernels``).

The same inputs, made with numpy from a seed, go through the reference's
``repro.kernels.ops`` (Pallas body in interpret mode, and the jnp oracle)
and the port's ``repro_torch.kernels.ops`` on the CPU, where the wrappers
run each kernel's plain version and the autograd Functions their chunked
recompute backward.  Forward and gradients agree within atol 1e-5,
rtol 1e-4 (fp32, summation order differs).  The CUDA kernels themselves
are held against the plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.chunked_ce import chunked_cross_entropy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _attn_inputs(seed, B, Tq, Tk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Tq, Hq, D)).astype(np.float32))


def _torch_attn(q, k, v, g, **opts):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tops.attention(qt, kt, vt, **opts)
    (out * torch.tensor(g)).sum().backward()
    return (out.detach().numpy(),
            [t.grad.numpy() for t in (qt, kt, vt)])


def _jax_attn(q, k, v, g, force, **opts):
    kw = dict(block_q=8, block_k=8) if force == "interpret" else {}

    @jax.jit     # one compile, not one per eager op
    def fwd_bwd(q_, k_, v_, g_):
        out, vjp = jax.vjp(
            lambda a, b, c: jops.attention(a, b, c, force=force, **opts,
                                           **kw), q_, k_, v_)
        return out, vjp(g_)

    out, grads = fwd_bwd(q, k, v, g)
    return np.asarray(out), [np.asarray(x) for x in grads]


ATTN_CASES = {
    # name: (B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset)
    "causal_gqa2": (2, 16, 16, 4, 2, 8, True, 0, 0),
    "ragged_tk": (1, 13, 13, 4, 2, 8, True, 0, 0),
    "tq_ne_tk_ragged": (1, 8, 21, 2, 1, 8, False, 0, 0),
    "sliding_window": (2, 24, 24, 4, 2, 8, True, 5, 0),
    "non_causal": (1, 12, 12, 6, 2, 16, False, 0, 0),
    "q_offset": (1, 6, 19, 4, 4, 8, True, 0, 11),
    "window_offset_group7": (1, 9, 20, 7, 1, 8, True, 6, 9),
}


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference(case, force):
    B, Tq, Tk, Hq, Hkv, D, causal, window, q_offset = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(sum(map(ord, case)), B, Tq, Tk, Hq, Hkv, D)
    opts = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    out_t, grads_t = _torch_attn(q, k, v, g, **opts)
    out_j, grads_j = _jax_attn(q, k, v, g, force, **opts)
    _close(out_t, out_j, f"{case} forward")
    for name, a, b in zip("qkv", grads_t, grads_j):
        _close(a, b, f"{case} d{name}")


def test_attention_backward_ragged_q_chunks():
    """Tq = 600 spans two backward chunks of 512 rows, the second ragged.
    The port's gradient equals autodiff of the reference oracle; the
    reference's own chunked custom_vjp slices a fixed 512-row window there
    and is wrong (ROADMAP.md queue 3), so it is not the yardstick here."""
    q, k, v, g = _attn_inputs(3, 1, 600, 600, 2, 1, 8)
    out_t, grads_t = _torch_attn(q, k, v, g, causal=True)
    out_j, grads_j = _jax_attn(q, k, v, g, "ref", causal=True)
    _close(out_t, out_j, "forward")
    for name, a, b in zip("qkv", grads_t, grads_j):
        _close(a, b, f"d{name}")


def _ce_inputs(seed, B, T, D, V, ignore):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    lbl = rng.integers(0, V, size=(B, T)).astype(np.int32)
    if ignore == "all":
        lbl[:] = -100
    elif ignore:
        lbl[rng.random((B, T)) < ignore] = -100
    return h, w, lbl


CE_CASES = {
    # name: (B, T, D, V, ignored share)
    "ragged_vocab": (2, 7, 16, 37, 0.0),
    "some_ignored": (2, 9, 12, 64, 0.3),
    "all_ignored": (1, 5, 8, 20, "all"),
    "ragged_tokens": (3, 5, 24, 50, 0.2),
}


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_reference(case, force):
    h, w, lbl = _ce_inputs(sum(map(ord, case)), *CE_CASES[case])
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss_t, n_t = tops.cross_entropy(ht, wt, torch.tensor(lbl))
    (loss_t * 1.7).backward()

    kw = dict(block_t=4, block_v=16) if force == "interpret" else {}
    @jax.jit     # one compile, not one per eager op
    def fwd_bwd(h_, w_):
        (loss, n), vjp = jax.vjp(
            lambda a, b: jops.cross_entropy(a, b, lbl, force=force, **kw),
            h_, w_)
        return loss, n, vjp((jnp.float32(1.7), jnp.zeros_like(n)))

    loss_j, n_j, (dh, dw) = fwd_bwd(h, w)
    assert int(n_t) == int(n_j)
    _close(loss_t.item(), np.asarray(loss_j), f"{case} loss")
    _close(ht.grad.numpy(), dh, f"{case} d hidden")
    _close(wt.grad.numpy(), dw, f"{case} d lm_head")


def test_cross_entropy_backward_chunks_tokens():
    """More tokens than one backward chunk: the chunked recompute equals
    the one-chunk gradient."""
    h, w, lbl = _ce_inputs(5, 2, 40, 8, 30, 0.25)
    grads = []
    for chunk in (16, 2048):
        ht, wt = torch.tensor(h), torch.tensor(w)
        grads.append(tops.cross_entropy_bwd(ht, wt, torch.tensor(lbl),
                                            torch.tensor(1.0), chunk=chunk))
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), "chunked vs whole")


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers are exactly their plain versions and
    launch no kernel."""
    q, k, v, _ = _attn_inputs(0, 1, 8, 8, 4, 2, 8)
    qt, kt, vt = map(torch.tensor, (q, k, v))
    h, w, lbl = _ce_inputs(0, 1, 6, 8, 20, 0.2)
    before = (flash_attention.launches, chunked_cross_entropy.launches)
    assert torch.equal(flash_attention(qt, kt, vt),
                       tref.attention(qt, kt, vt))
    loss, n = chunked_cross_entropy(*map(torch.tensor, (h, w, lbl)))
    ref_loss, ref_n = tref.cross_entropy_logits(*map(torch.tensor,
                                                     (h, w, lbl)))
    assert torch.equal(loss, ref_loss) and int(n) == int(ref_n)
    assert (flash_attention.launches,
            chunked_cross_entropy.launches) == before


def test_cross_entropy_rows_are_the_terms_of_the_mean():
    """The per-token NLL entry: on the CPU its plain version, whose mean
    over valid labels is the plain CE, with no launch; float64 in gives
    float64 out (the yardstick of the kernel's precision on the card)."""
    from repro_torch.kernels.chunked_ce import cross_entropy_rows
    h, w, lbl = map(torch.tensor, _ce_inputs(4, 2, 9, 12, 40, 0.3))
    before = chunked_cross_entropy.launches
    rows = cross_entropy_rows(h, w, lbl)
    assert chunked_cross_entropy.launches == before
    assert rows.shape == (18,) and rows.dtype == torch.float32
    assert bool((rows[lbl.reshape(-1) < 0] == 0).all())
    loss, n = tref.cross_entropy_logits(h, w, lbl)
    _close(rows.sum().item() / int(n), loss.item(), "mean of rows")
    rows64 = tref.cross_entropy_rows(h.double(), w.double(), lbl)
    assert rows64.dtype == torch.float64
    _close(rows64.numpy(), rows.numpy(), "float64 rows")
