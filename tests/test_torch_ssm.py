"""The attention-free family of the port (mamba2, rwkv6) vs the reference.

The same inputs, made with numpy from a seed, go through the reference
(``repro.kernels.ops`` with the Pallas body in interpret mode and with the
jnp oracle; ``repro.models`` and ``repro.core.blockwise`` with the oracle
kernels) and through the port on the CPU, where the kernel wrappers run
their plain versions and the autograd Functions their chunked recompute
backward.  Parameters are the reference's, carried across by
``repro_torch.testing.convert``.  Tolerance: atol 1e-5, rtol 1e-4 (fp32,
summation order differs) on outputs, final states, losses, every gradient
and every parameter after a multi-block client update.  The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.core.memory_model import lm_memory  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
ARCHS = ("mamba2-370m", "rwkv6-7b")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------- the scans
def _scan_inputs(kind, seed, T=37):
    """Inputs, the (y, state) cotangents, and the argument names."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if kind == "mamba2":
        B, H, P, N = 2, 2, 16, 8
        args = (n(B, T, H, P), np.log1p(np.exp(n(B, T, H))).astype(
            np.float32), -np.exp(n(H)), n(B, T, N), n(B, T, N), n(H),
            n(B, H, P, N))
        names = ("x", "dt", "A", "Bm", "Cm", "D", "s0")
        cot = (n(B, T, H, P), n(B, H, P, N))
    else:
        B, H, D = 2, 2, 16
        args = (n(B, T, H, D), n(B, T, H, D), n(B, T, H, D),
                n(B, T, H, D, scale=0.5) - 0.5, n(H, D, scale=0.1),
                n(B, H, D, D))
        names = ("r", "k", "v", "w", "u", "s0")
        cot = (n(B, T, H, D), n(B, H, D, D))
    return args, cot, names


def _torch_scan(kind, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, s = (tops.mamba2 if kind == "mamba2" else tops.rwkv6)(*ts)
    ((y * torch.tensor(cot[0])).sum()
     + (s * torch.tensor(cot[1])).sum()).backward()
    return y.detach().numpy(), s.detach().numpy(), [t.grad.numpy()
                                                    for t in ts]


def _jax_scan(kind, args, cot, force):
    kw = dict(block_t=8) if force == "interpret" else {}
    op = jops.mamba2 if kind == "mamba2" else jops.rwkv6

    @jax.jit     # one compile, not one per eager op
    def fwd_bwd(*a):
        (y, s), vjp = jax.vjp(lambda *b: op(*b, force=force, **kw), *a)
        return y, s, vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))

    y, s, grads = fwd_bwd(*args)
    return np.asarray(y), np.asarray(s), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("kind", ["mamba2", "rwkv6"])
def test_scan_ops_match_reference(kind, force):
    """Forward (y and final state) and the gradient of every input,
    including the initial state, under a non-zero final-state cotangent.
    T = 37 is ragged against block_t = 8 and spans two of the reference's
    backward chunks (4 * block_t)."""
    args, cot, names = _scan_inputs(kind, 7)
    y_t, s_t, g_t = _torch_scan(kind, args, cot)
    y_j, s_j, g_j = _jax_scan(kind, args, cot, force)
    _close(y_t, y_j, f"{kind} y")
    _close(s_t, s_j, f"{kind} final state")
    for name, a, b in zip(names, g_t, g_j):
        _close(a, b, f"{kind} d{name}")


@pytest.mark.parametrize("kind", ["mamba2", "rwkv6"])
def test_scan_backward_chains_chunks(kind):
    """The chunked recompute with chunks of 8 steps (five chunks, the last
    ragged) gives the gradient of one whole-sequence chunk, and that equals
    autograd through the plain sequential scan."""
    args, cot, names = _scan_inputs(kind, 11)
    ts = [torch.tensor(a) for a in args]
    gy, gs = map(torch.tensor, cot)
    if kind == "mamba2":
        x, dt, A, Bm, Cm, D, s0 = ts
        run = (lambda c: tops.scan_chunk_bwd(
            tops._mamba2_recompute, (x, dt, Bm, Cm), (A, D), s0, gy, gs, c))
        order = (0, 1, 4, 2, 3, 5, 6)     # seq (x, dt, B, C), A, D, s0
        plain = tref.mamba2_scan
    else:
        r, k, v, w, u, s0 = ts
        run = (lambda c: tops.scan_chunk_bwd(
            tref.rwkv6_scan, (r, k, v, w), (u,), s0, gy, gs, c))
        order = (0, 1, 2, 3, 4, 5)
        plain = tref.rwkv6_scan
    grads = []
    for chunk in (8, 37):
        seq, bc, ds = run(chunk)
        flat = [*seq, *bc, ds]
        grads.append([flat[j] for j in order])
    leaves = [t.clone().requires_grad_() for t in ts]
    y, s = plain(*leaves)
    auto = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), leaves)
    for name, a, b, c in zip(names, *grads, auto):
        _close(a.numpy(), b.numpy(), f"{kind} d{name}: 8-step vs whole")
        _close(a.numpy(), c.numpy(), f"{kind} d{name}: vs autograd")


@pytest.mark.parametrize("T,dt_scale,chunk", [(37, 1.0, 8), (37, 30.0, 64),
                                              (1, 1.0, 64), (64, 5.0, 16)])
def test_mamba2_chunked_form_matches_sequential(T, dt_scale, chunk):
    """The SSD chunked form the backward recomputes with equals the
    sequential scan, forward and gradients; large steps (dt x 30) give
    finite gradients because the masked entries are -inf before exp."""
    args, cot, names = _scan_inputs("mamba2", T + chunk, T=T)
    args = list(args)
    args[1] = args[1] * np.float32(dt_scale)
    outs = []
    for fn in (tref.mamba2_scan,
               lambda *a: tref.mamba2_scan_chunked(*a, chunk=chunk)):
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        y, s = fn(*leaves)
        g = torch.autograd.grad((y * torch.tensor(cot[0])).sum()
                                + (s * torch.tensor(cot[1])).sum(), leaves)
        outs.append([y.detach(), s.detach(), *g])
    for name, a, b in zip(("y", "state", *names), *outs):
        assert torch.isfinite(b).all(), name
        scale = float(a.abs().max()) or 1.0
        _close(b.numpy() / scale, a.numpy() / scale, f"{name} (T={T})")


def test_scan_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the scan wrappers are exactly their plain versions
    and launch no kernel."""
    m_args = [torch.tensor(a) for a in _scan_inputs("mamba2", 0)[0]]
    r_args = [torch.tensor(a) for a in _scan_inputs("rwkv6", 0)[0]]
    before = (mamba2_scan.launches, rwkv6_scan.launches)
    for fn, plain, a in ((mamba2_scan, tref.mamba2_scan, m_args),
                         (rwkv6_scan, tref.rwkv6_scan, r_args)):
        for got, want in zip(fn(*a), plain(*a)):
            assert torch.equal(got, want)
    assert (mamba2_scan.launches, rwkv6_scan.launches) == before


# --------------------------------------------------------------- the models
def _perturb(jparams):
    """Non-trivial norm scales, biases, decays and skips, so that the
    checks see every parameter.  The embedding is scaled to unit size: at
    the init's 0.02 the rms-norm that reads it amplifies fp32 rounding
    ~50x, and rwkv6's embedding gradient (largest entry ~12) then sits
    6e-5 from a float64 run on either side, over the tolerance."""
    rng = np.random.default_rng(1)
    names = ("norm", "ln_x", "conv_b", "dt_bias", "A_log", "['D']")

    def fn(path, a):
        key = jax.tree_util.keystr(path)
        if key == "['embed']":
            return a * np.float32(50.0)
        if any(n in key for n in names):
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fn, _np(jparams))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(j_reduced(arch), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    # jitted: the eager init compiles every random draw on its own
    jparams = _perturb(jax.jit(j_build(jcfg).init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    batches_np = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        batches_np.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    batches_np[0]["labels"][0, :3] = -100
    batches_t = [{k: torch.as_tensor(v, dtype=torch.int64)
                  for k, v in b.items()} for b in batches_np]
    return jcfg, cfg, jparams, batches_np, batches_t


def test_init_matches_reference_tree(model):
    """The port's own init builds the reference's tree: same keys, same
    shapes, per-layer entries for the stacked rows."""
    jcfg, cfg, jparams, _, _ = model
    own = params_to_reference(build(cfg).init(0, device="cpu"))
    fa = jax.tree_util.tree_flatten_with_path(own)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert {jax.tree_util.keystr(p) for p, _ in fa} == \
        {jax.tree_util.keystr(p) for p in fb}
    for path, a in fa:
        assert a.shape == fb[path].shape, jax.tree_util.keystr(path)


def test_loss_and_gradients_match_reference(model):
    jcfg, cfg, jparams, batches_np, batches_t = model
    jlm = j_build(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batches_np[0], kernel_force="ref"),
        has_aux=True))(jparams)
    params = params_from_reference(jparams, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, met = build(cfg).loss_fn(params, batches_t[0])
    grads = torch.autograd.grad(loss, leaves)
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == 19
    _close(loss.item(), jloss, "loss")
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    grad_tree = params_to_reference(tree_map(lambda t: by_id[id(t)],
                                             params))
    flat_t = jax.tree_util.tree_flatten_with_path(grad_tree)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(_np(jgrads))[0])
    assert len(flat_t) == len(flat_j)
    for path, g in flat_t:
        _close(g, flat_j[path], f"grad {jax.tree_util.keystr(path)}")
    if cfg.tie_embeddings:   # the head trains the table through embed.T
        assert float(by_id[id(params["embed"])].abs().max()) > 0


def test_runner_contract_matches_reference(model):
    """embed / apply_units over every [lo, hi) / head_loss agree with the
    reference runner; prefix_stable is False for the tied mamba2 and True
    for rwkv6; split takes [lo, hi) + head (+ embed at lo == 0) by
    reference and merge replaces exactly [lo, hi)."""
    jcfg, cfg, jparams, batches_np, batches_t = model
    jr = jbw.lm_runner(j_build(jcfg), kernel_force="ref")
    params = params_from_reference(jparams, device="cpu")
    tr = tbw.lm_runner(build(cfg))
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)
    assert tr.prefix_stable == (cfg.name == "rwkv6-7b")

    z0_t = tr.embed(params, batches_t[0])
    z0_j = jr.embed(jparams, batches_np[0])
    _close(z0_t, z0_j, "embed", atol=0, rtol=0)
    zs_j = {0: z0_j}
    for hi in range(1, 5):
        zs_j[hi] = jr.apply_units(jparams, zs_j[hi - 1], hi - 1, hi)
    for lo in range(4):
        for hi in range(lo + 1, 5):
            _close(tr.apply_units(params, torch.tensor(
                np.array(zs_j[lo])), lo, hi), zs_j[hi],
                f"apply_units [{lo}, {hi})")
    z4 = tr.apply_units(params, z0_t, 0, 4)
    _close(tr.head_loss(params, z4, batches_t[0], 3).item(),
           jr.head_loss(jparams, zs_j[4], batches_np[0], 3), "head_loss")
    _close(tbw.full_model_loss(tr, params, batches_t[1]).item(),
           jbw.full_model_loss(jr, jparams, batches_np[1]),
           "full_model_loss")

    for lo, hi in ((0, 1), (1, 3), (0, 4)):
        tsplit, jsplit = tr.split(params, lo, hi), jr.split(jparams, lo, hi)
        assert set(tsplit) == set(jsplit), (lo, hi)
        assert all(a is b for a, b in zip(tsplit["layers"],
                                          params["layers"][lo:hi]))
        fresh = tree_map(torch.clone, tsplit)
        merged = tr.merge(params, fresh, lo=lo, hi=hi)
        for i, layer in enumerate(merged["layers"]):
            assert (layer is params["layers"][i]) == (not lo <= i < hi)
        for k in params:
            if k != "layers":
                assert (merged[k] is params[k]) == (k not in fresh), k


def test_prefix_cache_on_equals_off(model):
    """Buffering z_{lo-1} (re-buffered per subproblem for the tied mamba2,
    advanced for rwkv6) gives the parameters of re-running the prefix in
    every step; the buffers hold the bytes the memory model prices."""
    _, cfg, jparams, _, batches_t = model
    runner = tbw.lm_runner(build(cfg))
    params = params_from_reference(jparams, device="cpu")
    blocks = ((1, 2), (2, 4))
    dec = TDec(blocks, 1, 0)
    cache = tbw.PrefixCache(runner)
    on = tbw.client_update(runner, params, dec, batches_t, lr=0.05,
                           prefix_cache=cache)
    off = tbw.client_update(runner, params, dec, batches_t, lr=0.05,
                            prefix_cache=False)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    B, T = batches_t[0]["tokens"].shape
    mem = lm_memory(cfg, B, T, act_bytes=4)
    assert cache.buffered_bytes() == mem.buffered_z_bytes(
        blocks[-1][0], n_batches=len(batches_t))


def test_client_update_matches_reference(model):
    """A three-block update from the embedding (blocks [0:1] [1:3] [3:4],
    one local step over two batches: two SGD steps per block) leaves every
    parameter where the reference's does.  (Four steps per block at this
    learning rate amplify fp32 rounding in rwkv6 to ~5e-5 on either side,
    so the steps are kept to two.)"""
    jcfg, cfg, jparams, batches_np, batches_t = model
    blocks = ((0, 1), (1, 3), (3, 4))
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    jout = jbw.client_update(
        jbw.lm_runner(j_build(jcfg), kernel_force="ref"),
        jax.tree.map(jnp.asarray, jparams), Decomposition(blocks, 0, 0),
        batches_np, **kw)
    params = params_from_reference(jparams, device="cpu")
    out = tbw.client_update(tbw.lm_runner(build(cfg)), params,
                            TDec(blocks, 0, 0), batches_t, **kw)
    fa = jax.tree_util.tree_flatten_with_path(params_to_reference(out))[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(_np(jout))[0])
    f0 = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(fa) == len(fb)
    moved = 0
    for path, a in fa:
        _close(a, fb[path], jax.tree_util.keystr(path))
        moved += not np.array_equal(fb[path], f0[path])
    assert moved > 0
