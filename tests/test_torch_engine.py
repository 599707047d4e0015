"""Port FeDepth round engine vs the reference engine (PyTorch port).

Two FeDepth rounds over the synthetic noisy-successor LM task on each
ported family, reduced and cut to 4 layers: the dense qwen2-7b and the
attention-free mamba2-370m (tied head) and rwkv6-7b (6 clients,
participation 0.5, fair budgets: multi-block and partial-training clients
in the cohorts).  Both engines
start from the reference's initial parameters (converted) and draw from
``np.random.default_rng(seed)`` in the same order, so cohort ids and
batches must be identical; server parameters agree every round within
atol 1e-4, rtol 1e-3, and so do the evaluations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.seq import build_lm_context as j_context  # noqa: E402
from repro.fl.seq import build_seq_data as j_data  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)

SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=4, scenario="fair", seed=0)
DATA = dict(n_per_client=12, n_test=16, seq_len=16, seed=0)


def _record(engine, cohorts, batches, state_log, to_host):
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
        batches.append((k, [{n: np.asarray(to_np(v)) for n, v in b.items()}
                            for b in out]))
        return out

    return recording_batch_fn


def to_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-370m", "rwkv6-7b"])
def test_two_rounds_match_reference_engine(arch):
    jcfg = dataclasses.replace(j_reduced(arch), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=4)

    jctx = j_context(j_data(6, vocab_size=jcfg.vocab_size, **DATA),
                     JSim(**SIM), jcfg, kernel_force="ref")
    ctx = build_lm_context(build_seq_data(6, vocab_size=cfg.vocab_size,
                                          device="cpu", **DATA),
                           SimConfig(**SIM), cfg, device="cpu")
    assert [d.blocks for d in ctx.decomps] == \
        [d.blocks for d in jctx.decomps]
    assert max(len(d.blocks) for d in ctx.decomps) >= 2

    init = j_build(jcfg).init(jax.random.PRNGKey(0))
    runs = {}
    for side, engine, state0, host in (
            ("jax", JEngine(j_get_strategy("fedepth"), jctx), init,
             lambda s: jax.tree.map(np.asarray, s)),
            ("torch", RoundEngine(get_strategy("fedepth"), ctx),
             params_from_reference(jax.tree.map(np.asarray, init),
                                   device="cpu"), params_to_reference)):
        cohorts, batches, states = [], [], []
        batch_fn = _record(engine, cohorts, batches, states, host)
        _, history = engine.run(initial_state=state0, batch_fn=batch_fn,
                                eval_every=1)
        runs[side] = (cohorts, batches, states, history)

    (jc, jb, js, jh), (tc, tb, ts, th) = runs["jax"], runs["torch"]
    assert tc == jc and len(tc) == 2
    assert any(len(ctx.decomps[k].blocks) >= 2 for ids in tc for k in ids)
    assert len(tb) == len(jb) == 6
    for (k1, b1), (k2, b2) in zip(tb, jb):
        assert k1 == k2 and len(b1) == len(b2)
        for x, y in zip(b1, b2):
            for name in ("tokens", "labels"):
                assert np.array_equal(x[name], y[name])
    assert len(ts) == len(js) == 2
    for rd, (a, b) in enumerate(zip(ts, js)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert len(fa) == len(fb)
        for path, x in fa:
            np.testing.assert_allclose(
                x, fb[path], atol=1e-4, rtol=1e-3,
                err_msg=f"round {rd + 1} {jax.tree_util.keystr(path)}")
    assert [r.round for r in th] == [r.round for r in jh] == [1, 2]
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / (16 * 16)


@pytest.mark.parametrize("knob", [
    dict(scheduler="sharded"), dict(codec="fp16"),
    dict(downlink="delta"), dict(obs="on"), dict(checkpoint_every=1),
    dict(faults=object()), dict(resume=True)])
def test_unported_engine_knobs_raise(knob):
    cfg = get_reduced_config("qwen2-7b")
    ctx = build_lm_context(build_seq_data(4, vocab_size=cfg.vocab_size,
                                          device="cpu", **DATA),
                           SimConfig(**SIM), cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        RoundEngine(get_strategy("fedepth"), ctx, **knob)
