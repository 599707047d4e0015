"""The hybrid zamba2 of the port vs the reference (PyTorch port).

Reduced zamba2-1.2b (4 layers, a shared block every 2: two groups of one
mamba layer and one shared attention + SwiGLU invocation).  The
reference runs with ``kernel_force="ref"`` (the jnp oracles), the port
on the CPU (the kernels' plain versions); parameters are the
reference's, norms, conv biases, decays and skips perturbed so that
every parameter counts, carried across by ``repro_torch.testing.convert``
(``mamba_groups`` as a list of groups of per-layer dicts).  Inputs come
from numpy seeds.

Tolerances: the loss, every gradient, the hidden states of every
``[lo, hi)`` and prefill logits atol 1e-5 / rtol 1e-4 (fp32, a different
summation order); decode logits atol 1e-4 / rtol 1e-3 and the caches as
in ``tests/test_torch_serve.py``; parameters after a client update atol
1e-5 / rtol 1e-4; after two engine rounds atol 1e-4 / rtol 1e-3.
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
from repro.models import build as j_build  # noqa: E402
from repro.models import zamba2 as j_zamba2  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.models import build, zamba2  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_serve import _decode_both, _perturb, models  # noqa: E402,F401
from torch_helpers import (assert_trees_close, lm_engine_parity,  # noqa: E402,F401
                           one_torch_thread)

ARCH = "zamba2-1.2b"
ATOL, RTOL = 1e-5, 1e-4


def _close(a, b, msg, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_reduced(ARCH), get_reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jlm = j_build(jcfg)
    jparams = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    batches_np = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
        batches_np.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    batches_np[0]["labels"][0, :3] = -100
    batches_t = [{k: torch.as_tensor(v, dtype=torch.int64)
                  for k, v in b.items()} for b in batches_np]
    return jcfg, cfg, jlm, jparams, batches_np, batches_t


def _params(jparams):
    return params_from_reference(jparams, device="cpu")


def test_config_and_tree_match_reference(setup):
    """Configs field by field (published and reduced); the group layout
    and depth units; the port's own init builds the reference's tree
    (keys and shapes), ``mamba_groups`` a list of G lists of M dicts."""
    jcfg, cfg, jlm, jparams, _, _ = setup
    from repro.configs import get_config as j_config
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_config(ARCH))
    for c in (cfg, get_config(ARCH)):
        assert zamba2.group_layout(c) == j_zamba2.group_layout(c)
        assert build(c).num_depth_units == j_build(c).num_depth_units
    assert zamba2.group_layout(get_config(ARCH)) == (6, 5)
    own = build(cfg).init(0, device="cpu")
    assert [len(g) for g in own["mamba_groups"]] == [1, 1]
    fa = jax.tree_util.tree_flatten_with_path(params_to_reference(own))[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert {jax.tree_util.keystr(p) for p, _ in fa} == \
        {jax.tree_util.keystr(p) for p in fb}
    for path, a in fa:
        assert a.shape == fb[path].shape, jax.tree_util.keystr(path)


def test_loss_and_gradients_match_reference(setup):
    """``loss_fn`` (K1's, K2's and K3's plain versions) and the gradient
    of every leaf, the shared block's and the invocation norms'
    included."""
    jcfg, cfg, jlm, jparams, batches_np, batches_t = setup
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batches_np[0], kernel_force="ref"),
        has_aux=True))(jparams)
    params = _params(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, met = build(cfg).loss_fn(params, batches_t[0])
    grads = torch.autograd.grad(loss, leaves)
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == 21
    _close(loss.item(), jloss, "loss")
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    assert_trees_close(params_to_reference(tree_map(lambda t: by_id[id(t)],
                                                    params)),
                       jax.tree.map(np.asarray, jgrads), "grad",
                       atol=ATOL, rtol=RTOL)
    assert float(by_id[id(params["shared"]["attn"]["wq"])].abs().max()) > 0


def test_apply_group_range_every_range(setup):
    """``apply_group_range`` over every [lo, hi) of the two groups, from
    the reference's hidden states at lo, equals the reference's."""
    jcfg, cfg, jlm, jparams, batches_np, _ = setup
    params = _params(jparams)
    x = np.asarray(jparams["embed"])[batches_np[0]["tokens"]]
    zs = {0: x}
    for hi in (1, 2):
        zs[hi] = np.asarray(j_zamba2.apply_group_range(
            jparams, jcfg, zs[hi - 1], hi - 1, hi, kernel_force="ref")[0])
    for lo in range(2):
        for hi in range(lo + 1, 3):
            got, aux = zamba2.apply_group_range(params, cfg,
                                                torch.tensor(zs[lo]), lo, hi)
            assert aux == 0.0
            _close(got, zs[hi], f"groups [{lo}, {hi})")


def test_prefill_matches_reference(setup):
    jcfg, cfg, jlm, jparams, batches_np, _ = setup
    toks = batches_np[1]["tokens"]
    want = jax.jit(lambda p, b: jlm.prefill(p, b, kernel_force="ref"))(
        jparams, {"tokens": toks})
    got = build(cfg).prefill(_params(jparams),
                             {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want, "prefill")


def test_decode_matches_reference(models):
    """8 decode steps from a random cache at cache_index 3, each from the
    reference's cache before it (mamba states stacked over the groups'
    layers, one K / V per shared invocation): logits and the new cache,
    the conv tails in fp32 after a step on both sides."""
    _decode_both(models, ARCH, steps=8, seq=16, start=3, mrope=False,
                 seed=4)


def test_runner_contract_matches_reference(setup):
    """The runner of ``tests/test_adapters.py``: ``prefix_stable`` is
    False (the shared block trains with the head); units compose over
    ranges; ``merge(split)`` is the identity and shares every tensor;
    merge replaces exactly groups [lo, hi) and the head keys (``shared``
    and ``invocation_norms`` among them); embed / apply_units /
    head_loss agree with the reference runner."""
    jcfg, cfg, jlm, jparams, batches_np, batches_t = setup
    jr = jbw.lm_runner(jlm, kernel_force="ref")
    tr = tbw.lm_runner(build(cfg))
    params = _params(jparams)
    assert (tr.n_units, tr.prefix_stable) == (jr.n_units, jr.prefix_stable)
    assert (tr.n_units, tr.prefix_stable, tr.family) == (2, False, "hybrid")

    b, jb = batches_t[0], batches_np[0]
    z0 = tr.embed(params, b)
    _close(z0, jr.embed(jparams, jb), "embed", atol=0, rtol=0)
    full = tr.apply_units(params, z0, 0, 2)
    _close(tr.apply_units(params, tr.apply_units(params, z0, 0, 1), 1, 2),
           full, "range composition", atol=0, rtol=0)
    _close(full, jr.apply_units(jparams, jr.embed(jparams, jb), 0, 2),
           "apply_units [0, 2)")
    _close(tr.head_loss(params, full, b, 1).item(),
           jr.head_loss(jparams, np.asarray(full), jb, 1), "head_loss")

    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        tsplit, jsplit = tr.split(params, lo, hi), jr.split(jparams, lo, hi)
        assert set(tsplit) == set(jsplit), (lo, hi)
        assert {"shared", "invocation_norms", "lm_head",
                "final_norm"} <= set(tsplit)
        same = tr.merge(params, tsplit, lo=lo, hi=hi)
        assert all(a is b for a, b in zip(tree_leaves(same),
                                          tree_leaves(params)))
        fresh = tree_map(torch.clone, tsplit)
        merged = tr.merge(params, fresh, lo=lo, hi=hi)
        for g, group in enumerate(merged["mamba_groups"]):
            assert (group is params["mamba_groups"][g]) == \
                (not lo <= g < hi)
        for k in params:
            if k != "mamba_groups":
                assert (merged[k] is params[k]) == (k not in fresh), k
    # the shared block's leak into the prefix: bumping only the head keys
    # (a split over the last group) moves the output of group 0
    bumped = tree_map(lambda t: t + 0.01, tr.split(params, 1, 2))
    merged = tr.merge(params, bumped, lo=1, hi=2)
    assert float((tr.apply_units(merged, z0, 0, 1)
                  - tr.apply_units(params, z0, 0, 1)).abs().max()) > 0


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_client_update_matches_reference(setup, prefix_cache):
    """A two-block update ([0, 1), then [1, 2); two SGD steps a block
    over two batches) leaves every parameter where the reference's does:
    the shared block takes gradient from the groups inside [lo, hi) and
    none from the buffered (or, without the cache, re-run) prefix.  With
    the cache, the prefix is re-buffered for the second block (the first
    block moved the shared block)."""
    jcfg, cfg, jlm, jparams, batches_np, batches_t = setup
    blocks = ((0, 1), (1, 2))
    kw = dict(lr=0.05, momentum=0.9, local_steps=1)
    jout = jbw.client_update(jbw.lm_runner(jlm, kernel_force="ref"),
                             jax.tree.map(jnp.asarray, jparams),
                             Decomposition(blocks, 0, 0), batches_np, **kw)
    params = _params(jparams)
    runner = tbw.lm_runner(build(cfg))
    cache = tbw.PrefixCache(runner) if prefix_cache else False
    out = tbw.client_update(runner, params, TDec(blocks, 0, 0), batches_t,
                            prefix_cache=cache, **kw)
    assert_trees_close(params_to_reference(out),
                       jax.tree.map(np.asarray, jout), "client update",
                       atol=ATOL, rtol=RTOL)
    moved = params_to_reference(out)
    for key in ("shared", "invocation_norms", "lm_head"):
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(moved[key]), jax.tree.leaves(jparams[key])))
    if prefix_cache:
        assert len(cache.zs) == 2 and cache.buffered_bytes() == \
            2 * 2 * 12 * cfg.d_model * 4


def test_two_rounds_match_reference_engine():
    """Two FeDepth rounds through ``build_lm_context`` and the round
    engine, 6 clients at ``fair`` budgets over 72-token sequences (sim
    seed 1: a two-block client, a whole-model one and partial-training
    ones in the cohorts), against the reference's engine."""
    ctx, cohorts, _ = lm_engine_parity(
        j_reduced(ARCH), get_reduced_config(ARCH), "fedepth",
        data=dict(n_per_client=12, n_test=16, seq_len=72, seed=0),
        sim=dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
                 local_steps=1, batch_size=4, scenario="fair", seed=1))
    assert {len(ctx.decomps[k].blocks) for ids in cohorts for k in ids} \
        >= {2}
