"""Port depth-wise client update and FedAvg vs the reference (PyTorch port).

Reduced qwen2-7b cut to 4 layers so decompositions have several blocks
and a skipped prefix.  The reference's parameters (converted) and numpy
batches go through ``repro.core.blockwise.client_update`` (jnp oracle
kernels) and the port's, on the CPU.  Tolerance: atol 1e-5, rtol 1e-4 on
every parameter after a multi-block update (fp32, a few SGD steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import Decomposition  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import blockwise as tbw  # noqa: E402
from repro_torch.core.decomposition import Decomposition as TDec  # noqa: E402
from repro_torch.core.memory_model import lm_memory  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
DECOMPS = {
    "partial_advance": ((1, 2), (2, 4)),     # skipped prefix, then advance
    "from_embed": ((0, 2), (2, 3), (3, 4)),  # trains embed at lo == 0
}


def _cfgs():
    jcfg = dataclasses.replace(j_reduced("qwen2-7b"), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config("qwen2-7b"), num_layers=4)
    return jcfg, cfg


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    jparams = j_build(jcfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    batches_np = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        batches_np.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    batches_t = [{k: torch.as_tensor(v, dtype=torch.int64)
                  for k, v in b.items()} for b in batches_np]
    return jcfg, cfg, jparams, batches_np, batches_t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _diff(a_tree, b_tree):
    fa = jax.tree_util.tree_flatten_with_path(a_tree)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b_tree)[0])
    assert len(fa) == len(fb)
    return fa, fb


@pytest.mark.parametrize("name,prox_mu", [
    ("partial_advance", 0.0), ("from_embed", 0.0),
    ("partial_advance", 0.5)])          # the FedProx term as well
def test_client_update_matches_reference(setup, name, prox_mu):
    jcfg, cfg, jparams, batches_np, batches_t = setup
    blocks = DECOMPS[name]
    kw = dict(lr=0.05, momentum=0.9, local_steps=2, prox_mu=prox_mu)
    jout = jbw.client_update(
        jbw.lm_runner(j_build(jcfg), kernel_force="ref"), jparams,
        Decomposition(blocks, blocks[0][0], 0), batches_np, **kw)
    params = params_from_reference(_np(jparams), device="cpu")
    out = tbw.client_update(tbw.lm_runner(build(cfg)), params,
                            TDec(blocks, blocks[0][0], 0), batches_t, **kw)
    fa, fb = _diff(params_to_reference(out), _np(jout))
    f0 = dict(jax.tree_util.tree_flatten_with_path(_np(jparams))[0])
    moved = 0
    for path, a in fa:
        np.testing.assert_allclose(a, fb[path], atol=ATOL, rtol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))
        moved += not np.array_equal(fb[path], f0[path])
    assert moved > 0


@pytest.mark.parametrize("name", sorted(DECOMPS))
def test_client_update_prefix_cache_on_equals_off(setup, name):
    """Buffering z_{lo-1} (and advancing it) gives the same params as
    re-running the prefix in every step; the cache holds exactly the
    bytes the memory model prices for the last block's buffer."""
    jcfg, cfg, jparams, _, batches_t = setup
    blocks = DECOMPS[name]
    runner = tbw.lm_runner(build(cfg))
    params = params_from_reference(_np(jparams), device="cpu")
    dec = TDec(blocks, blocks[0][0], 0)
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


def test_client_update_owns_only_what_it_trains(setup):
    """The update never writes its input; the result shares every tensor
    it did not train with the input and owns fresh ones for the rest
    (units of its blocks, the head, and embed when a block starts at 0)."""
    jcfg, cfg, jparams, _, batches_t = setup
    runner = tbw.lm_runner(build(cfg))
    params = params_from_reference(_np(jparams), device="cpu")
    snapshot = [t.clone() for t in tree_leaves(params)]
    for blocks, trained_units, embed_fresh in (
            (((1, 2), (2, 4)), {1, 2, 3}, False),
            (((0, 2),), {0, 1}, True)):
        out = tbw.client_update(runner, params,
                                TDec(blocks, blocks[0][0], 0), batches_t,
                                lr=0.05)
        for i in range(4):
            shared = [a is b for a, b in zip(tree_leaves(out["units"][i]),
                                             tree_leaves(params["units"][i]))]
            assert (not any(shared)) if i in trained_units else all(shared)
        assert (out["embed"] is not params["embed"]) == embed_fresh
        assert out["lm_head"] is not params["lm_head"]
        assert out["final_norm"] is not params["final_norm"]
        # untied embed: its lookup feeds the frozen prefix, zero gradient
        assert torch.equal(out["embed"], params["embed"])
    for a, b in zip(tree_leaves(params), snapshot):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prefix_cache,prox_mu,in_place", [
    (True, 0.0, True), (False, 0.0, False), (True, 0.5, False)])
def test_client_update_trains_its_own_copies_in_place(setup, prefix_cache,
                                                      prox_mu, in_place):
    """A block after the first trains the head copy that the blocks
    before it made, in place (one copy of the head for the whole update),
    when the prefix is buffered and no FedProx anchor reads the old
    value; otherwise each block clones it.  The input is never written
    and the result is the same either way."""
    jcfg, cfg, jparams, _, batches_t = setup
    runner = tbw.lm_runner(build(cfg))
    heads = []
    merge = runner.merge

    def recording_merge(params, train, lo=None, hi=None):
        if not train["lm_head"].requires_grad:   # a block's end, not a step
            heads.append(train["lm_head"])
        return merge(params, train, lo=lo, hi=hi)

    params = params_from_reference(_np(jparams), device="cpu")
    snapshot = [t.clone() for t in tree_leaves(params)]
    dec = TDec(((0, 1), (1, 3), (3, 4)), 0, 0)
    kw = dict(lr=0.05, momentum=0.9, prox_mu=prox_mu)
    out = tbw.client_update(dataclasses.replace(runner,
                                                merge=recording_merge),
                            params, dec, batches_t,
                            prefix_cache=prefix_cache, **kw)
    ptrs = {h.untyped_storage().data_ptr() for h in heads}
    assert len(heads) == 3
    assert len(ptrs) == (1 if in_place else 3)
    assert params["lm_head"].untyped_storage().data_ptr() not in ptrs
    for a, b in zip(tree_leaves(params), snapshot):
        assert torch.equal(a, b)
    cloned = tbw.client_update(runner, params, dec, batches_t,
                               prefix_cache=False, **kw)
    for a, b in zip(tree_leaves(out), tree_leaves(cloned)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_fedavg_matches_reference_and_drops_non_finite():
    rng = np.random.default_rng(5)
    trees = [{"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
             for _ in range(3)]
    weights = [16.0, 16.0, 32.0]
    want = jagg.fedavg(trees, weights)
    got = tagg.fedavg([{"a": torch.tensor(t["a"]),
                        "b": [torch.tensor(t["b"][0])]} for t in trees],
                      weights)
    np.testing.assert_allclose(got["a"].numpy(), want["a"], atol=1e-7,
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), want["b"][0],
                               atol=1e-7, rtol=1e-6)
    bad = [dict(t) for t in trees]
    bad[1] = {"a": np.full((3, 4), np.nan, np.float32), "b": trees[1]["b"]}
    want = jagg.fedavg(bad, weights)
    got = tagg.fedavg([{"a": torch.tensor(t["a"]),
                        "b": [torch.tensor(t["b"][0])]} for t in bad],
                      weights)
    assert np.isfinite(got["a"].numpy()).all()
    np.testing.assert_allclose(got["a"].numpy(), want["a"], atol=1e-7,
                               rtol=1e-6)
    # every payload non-finite: passed through, as the reference does
    allbad = tagg.fedavg([{"a": torch.full((2,), float("nan"))}] * 2,
                         [1.0, 1.0])
    assert torch.isnan(allbad["a"]).all()
    assert bool(jnp.isnan(jagg.fedavg(
        [{"a": np.full((2,), np.nan, np.float32)}] * 2, [1.0, 1.0])["a"]
    ).all())
