"""Port image-protocol engine vs the reference engine (PyTorch port).

The paper's own experiment at the verify recipe's tiny size: reduced
PreResNet (3 blocks, widths 8 / 16 / 32), 8 clients over a Dirichlet
(alpha 1) split of 640 synthetic 16 x 16 images, 2 rounds at
participation 0.5.  For ``fedepth`` and ``m-fedepth`` under ``fair``,
``fedepth`` under ``surplus`` (clients with r = 2 run MKD with M = 2) and
``fedavg`` (x min r) under ``fair``, both engines start from the
reference's initial parameters (converted) and draw from
``np.random.default_rng(seed)`` in the same order, so cohort ids and
batches must be identical; server parameters agree every round within
atol 1e-4, rtol 1e-3, and accuracies within one test image.

Also the port's own counterparts of the reference's learning and
invariant tests (``tests/test_fl.py``, ``tests/test_core.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.core import aggregation, blockwise, mkd  # noqa: E402
from repro_torch.core.decomposition import Decomposition  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, partition="dirichlet", alpha=1.0, n_train=640,
            n_test=200, image_size=16, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=32, seed=0)


def _to_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


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
        batches.append((k, [{n: _to_np(v) for n, v in b.items()}
                            for b in out]))
        return out

    return recording_batch_fn


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


@pytest.fixture(scope="module")
def ref_caches():
    """method -> the ``caches`` dict every reference context of that
    method shares: the reference's compiled client steps (keyed by the
    block's geometry and the optimizer's settings) then serve each of
    the method's cases (fedepth under "fair" and "surplus")."""
    return {}


@pytest.mark.parametrize("method,scenario", [
    ("fedepth", "fair"), ("m-fedepth", "fair"), ("fedepth", "surplus"),
    ("fedavg", "fair")])
def test_two_rounds_match_reference_engine(datasets, ref_caches, method,
                                          scenario):
    jdata, tdata = datasets
    jctx = j_context(jdata, JSim(scenario=scenario, **SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    jctx.caches = ref_caches.setdefault(method, jctx.caches)
    ctx = build_context(tdata, SimConfig(scenario=scenario, **SIM),
                        model_cfg=reduced(num_classes=10, image_size=16),
                        device="cpu")
    assert [d.blocks for d in ctx.decomps] == \
        [d.blocks for d in jctx.decomps]
    assert np.array_equal(ctx.surplus, jctx.surplus)
    assert dataclasses.astuple(ctx.mem) == dataclasses.astuple(jctx.mem)

    jstrat, tstrat = j_get_strategy(method), get_strategy(method)
    jstrat.setup(jctx)
    init = jax.tree.map(np.asarray, jstrat.init_state(jctx))
    runs = {}
    for side, engine, state0, host in (
            ("jax", JEngine(jstrat, jctx), init,
             lambda s: jax.tree.map(np.asarray, s)),
            ("torch", RoundEngine(tstrat, ctx),
             params_from_reference(init, device="cpu"),
             params_to_reference)):
        cohorts, batches, states = [], [], []
        batch_fn = _record(engine, cohorts, batches, states, host)
        _, history = engine.run(initial_state=state0, batch_fn=batch_fn,
                                eval_every=1)
        runs[side] = (cohorts, batches, states, history)

    (jc, jb, js, jh), (tc, tb, ts, th) = runs["jax"], runs["torch"]
    assert tc == jc and len(tc) == 2
    clients = [k for ids in tc for k in ids]
    if method != "fedavg":
        assert any(len(ctx.decomps[k].blocks) >= 2 for k in clients)
    if scenario == "surplus":      # an MKD client ran on both sides
        assert any(ctx.surplus[k] == 2 for k in clients)
    assert len(tb) == len(jb) == 8
    for (k1, b1), (k2, b2) in zip(tb, jb):
        assert k1 == k2 and len(b1) == len(b2)
        for x, y in zip(b1, b2):
            for name in ("images", "labels"):
                assert np.array_equal(x[name], y[name])
    assert len(ts) == len(js) == 2
    for rd, (a, b) in enumerate(zip(ts, js)):
        assert_trees_close(a, b, f"{method} {scenario} round {rd + 1}")
    assert [r.round for r in th] == [r.round for r in jh] == [1, 2]
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / DATA["n_test"]


def test_fedepth_learns_above_chance(datasets):
    """Port of ``tests/test_fl.py::test_fedepth_learns_above_chance``:
    single-round accuracy oscillates on this tiny config, so the claim is
    checked on the mean of the last three evals, well clear of chance
    (0.10 for 10 classes).  Like every parity test here, the run starts
    from the reference's initial parameters (its test's own, PRNG key 0),
    carried across: the 12-round tail of this config depends on the
    init (the reference from keys 1, 2, 4 ends at 0.13, 0.12, 0.12), and
    from key 0's parameters the port follows the reference's
    trajectory."""
    sim = SimConfig(rounds=12, participation=0.5, lr=0.08, local_steps=2,
                    batch_size=64, scenario="fair", seed=0)
    engine = RoundEngine(get_strategy("fedepth"),
                         build_context(datasets[1], sim,
                                       model_cfg=reduced(10, 16),
                                       device="cpu"))
    init = jax.jit(jresnet.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                   j_reduced(10, 16))
    _, hist = engine.run(initial_state=params_from_reference(
        jax.tree.map(np.asarray, init), device="cpu"), eval_every=2)
    tail = [rec.accuracy for rec in hist[-3:]]
    assert sum(tail) / len(tail) > 0.15


def _tiny_setup(seed):
    cfg = reduced(num_classes=4, image_size=16)
    params = resnet.init(seed, cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    batch = {"images": torch.randn(8, 16, 16, 3, generator=gen),
             "labels": torch.randint(0, 4, (8,), generator=gen)}
    return cfg, params, batch


def test_blockwise_frozen_prefix_invariant():
    """Training block j must not change blocks < j, nor the stem."""
    cfg, params, batch = _tiny_setup(1)
    runner = blockwise.resnet_runner(cfg)
    dec = Decomposition(((1, 2),), 0, 0)  # only the middle block trains
    p2 = blockwise.client_update(runner, params, dec, [batch], lr=0.05)
    for a, b in zip(tree_leaves(params["blocks"][0]),
                    tree_leaves(p2["blocks"][0])):
        assert torch.equal(a, b)
    assert torch.equal(params["stem"], p2["stem"])
    assert any(float((a - b).abs().max()) > 0 for a, b in zip(
        tree_leaves(params["blocks"][1]), tree_leaves(p2["blocks"][1])))
    assert float((params["classifier"]["w"]
                  - p2["classifier"]["w"]).abs().max()) > 0


def test_masked_aggregation_partial_clients():
    g = {"w": torch.zeros(2)}
    c1 = {"w": torch.ones(2)}          # trained
    c2 = {"w": torch.full((2,), 9.0)}  # did NOT train w
    out = aggregation.aggregate_masked(g, [c1, c2], [1.0, 1.0],
                                       [{"w": torch.ones(2)},
                                        {"w": torch.zeros(2)}])
    np.testing.assert_allclose(out["w"].numpy(), 1.0)  # only c1 counts


def test_mkd_converges_models():
    """Mutual KD pulls two different models' predictions together."""
    cfg, p1, batch = _tiny_setup(4)
    p2 = resnet.init(5, cfg, device="cpu")

    def logits_fn(p, b):
        return resnet.apply(p, cfg, b["images"])

    def task_fn(p, b):
        return blockwise._ce_logits(logits_fn(p, b), b["labels"])

    with torch.no_grad():
        kl0 = float(mkd.kl_logits(logits_fn(p1, batch), logits_fn(p2, batch)))
    out = mkd.mkd_local_update(logits_fn, task_fn, [p1, p2], [batch],
                               lr=0.05, local_steps=5)
    with torch.no_grad():
        kl1 = float(mkd.kl_logits(logits_fn(out[0], batch),
                                  logits_fn(out[1], batch)))
    assert kl1 < kl0
