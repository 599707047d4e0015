"""Helpers shared by the port's parity tests (not a test module): the
one-thread fixture, tree comparison, a two-round engine parity run of an
LM config against the reference's engine, and a mesh for the sharding
rules alone."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the importing module runs: the suite
    runs several test processes at once, and a full torch thread pool in
    each would oversubscribe the cores (these tensors are small; one
    thread is no slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def abstract_mesh(shape, axes):
    """A mesh's axis sizes and names without processes: all that
    ``repro_torch.launch.sharding``'s rules read (the reference's tests
    give its rules such a namespace too)."""
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(axes))


def assert_trees_close(a, b, msg, atol=1e-4, rtol=1e-3):
    """Two reference-layout trees hold the same leaves within
    ``atol`` / ``rtol``; a failure names the leaf."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb), msg
    for path, x in fa:
        np.testing.assert_allclose(
            x, fb[path], atol=atol, rtol=rtol,
            err_msg=f"{msg} {jax.tree_util.keystr(path)}")


def _record(engine, cohorts, batches, state_log, to_host):
    """Wrap ``engine``'s sampler and aggregate to record each round's
    cohort and new server state; return a batch_fn that records every
    client's batches (as numpy)."""
    sample = engine.sampler.sample

    def recording_sample(ctx, rd):
        ids = sample(ctx, rd)
        cohorts.append([int(k) for k in ids])
        return ids

    engine.sampler.sample = recording_sample
    aggregate = engine.strategy.aggregate

    def recording_aggregate(ctx, state, results):
        new = aggregate(ctx, state, results)
        state_log.append(to_host(new))
        return new

    engine.strategy.aggregate = recording_aggregate
    batch_fn = engine.default_batch_fn()

    def recording_batch_fn(k):
        out = batch_fn(k)
        batches.append((k, [{n: np.asarray(v.cpu().numpy() if isinstance(
            v, torch.Tensor) else v) for n, v in b.items()} for b in out]))
        return out

    return recording_batch_fn


def lm_engine_parity(jcfg, cfg, method: str = "fedepth", *, data: dict,
                     sim: dict, n_clients: int = 6, atol=1e-4, rtol=1e-3,
                     perturb=None):
    """Two rounds of ``method`` on an LM config through the reference's
    engine (``kernel_force="ref"``) and the port's, from the reference's
    initial parameters (m-FeDepth's ``aux_norms`` added as the
    strategies' ``init_state`` adds them; ``perturb`` maps the numpy
    tree first), over the same seeded data.  Cohorts and batches must be
    identical, the server parameters agree every round within ``atol`` /
    ``rtol``, and so do the bytes and the evaluations.  Returns the
    port's context, its cohorts and (the initial, the final) server
    state in the reference's layout."""
    from repro.fl.engine import RoundEngine as JEngine
    from repro.fl.engine import SimConfig as JSim
    from repro.fl.registry import get_strategy as j_get_strategy
    from repro.fl.seq import build_lm_context as j_context
    from repro.fl.seq import build_seq_data as j_data
    from repro.models import build as j_build
    from repro_torch.fl.engine import RoundEngine, SimConfig
    from repro_torch.fl.registry import get_strategy
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    from repro_torch.testing.convert import (params_from_reference,
                                             params_to_reference)

    jctx = j_context(j_data(n_clients, vocab_size=jcfg.vocab_size, **data),
                     JSim(**sim), jcfg, kernel_force="ref")
    ctx = build_lm_context(build_seq_data(n_clients,
                                          vocab_size=cfg.vocab_size,
                                          device="cpu", **data),
                           SimConfig(**sim), cfg, device="cpu")
    assert [d.blocks for d in ctx.decomps] == \
        [d.blocks for d in jctx.decomps]
    assert max(len(d.blocks) for d in ctx.decomps) >= 2

    jlm = j_build(jcfg)
    init = jax.tree.map(np.asarray, jax.jit(jlm.init)(
        jax.random.PRNGKey(0)))
    if method == "m-fedepth":
        init["aux_norms"] = np.ones((jlm.num_depth_units, jcfg.d_model),
                                    np.float32)
    if perturb is not None:
        init = perturb(init)
    runs = {}
    for side, engine, state0, host in (
            ("jax", JEngine(j_get_strategy(method), jctx),
             jax.tree.map(jax.numpy.asarray, init),
             lambda s: jax.tree.map(np.asarray, s)),
            ("torch", RoundEngine(get_strategy(method), ctx),
             params_from_reference(init, device="cpu"),
             params_to_reference)):
        cohorts, batches, states = [], [], []
        batch_fn = _record(engine, cohorts, batches, states, host)
        _, history = engine.run(initial_state=state0, batch_fn=batch_fn,
                                eval_every=1)
        runs[side] = (cohorts, batches, states, history)

    (jc, jb, js, jh), (tc, tb, ts, th) = runs["jax"], runs["torch"]
    assert tc == jc and len(tc) == 2
    assert any(len(ctx.decomps[k].blocks) >= 2 for ids in tc for k in ids)
    assert len(tb) == len(jb) == sum(len(ids) for ids in tc)
    for (k1, b1), (k2, b2) in zip(tb, jb):
        assert k1 == k2 and len(b1) == len(b2)
        for x, y in zip(b1, b2):
            for name in ("tokens", "labels"):
                assert np.array_equal(x[name], y[name])
    assert len(ts) == len(js) == 2
    for rd, (a, b) in enumerate(zip(ts, js)):
        assert_trees_close(a, b, f"{cfg.name} {method} round {rd + 1}",
                           atol=atol, rtol=rtol)
    assert [r.round for r in th] == [r.round for r in jh] == [1, 2]
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    n_test = data["n_test"] * data["seq_len"]
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / n_test
    return ctx, tc, (init, ts[-1])
