"""Port of the paper's baselines through the round engine vs the
reference engine (PyTorch port), on the CPU.

Image protocol at the verify recipe's tiny size (reduced PreResNet, 8
clients over a Dirichlet split of 640 synthetic 16 x 16 images, 2 rounds
at participation 0.5, ``fair``) for ``heterofl``, ``splitmix`` and
``depthfl``; and DepthFL's LM branch on the reduced mamba2-370m cut to 4
layers (6 clients, the synthetic noisy-successor task).  Both engines
start from the reference's initial state (converted: parameters,
SplitMix's base nets, DepthFL's aux heads) and draw from
``np.random.default_rng(seed)`` in the same order, so cohorts and batches
must be identical; the state agrees every round within atol 1e-4, rtol
1e-3, up and down bytes exactly, accuracies within one test item.

Also: the ports of the reference's sampler tests (``tests/test_engine.py``)
with the reference's cohorts for the same seeds, and the registry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_lm_reduced  # noqa: E402
from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl import sampling as jsampling  # noqa: E402
from repro.fl.baselines import SplitMixState as JSplitMix  # noqa: E402
from repro.fl.baselines import depthfl_init_aux as j_aux  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.seq import build_lm_context as j_lm_context  # noqa: E402
from repro.fl.seq import build_seq_data as j_seq_data  # noqa: E402
from repro.fl.strategy import Context as JContext  # noqa: E402
from repro.fl.strategy import tree_bytes as j_tree_bytes  # noqa: E402
from repro.fl.width import subnet_config as j_subnet  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl import registry  # noqa: E402
from repro_torch.fl.baselines import SplitMixState  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.sampling import (AvailabilityTraceSampler,  # noqa: E402
                                     StragglerSampler, UniformSampler)
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.fl.strategy import Context  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_bytes  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, partition="dirichlet", alpha=1.0, n_train=640,
            n_test=200, image_size=16, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, momentum=0.9,
           local_steps=1, batch_size=32, scenario="fair", seed=0)


def _to_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _run_recorded(engine, state0, to_host):
    """``engine.run`` over 2 rounds with evals, recording each round's
    cohort, every client's batches and the state after each aggregate."""
    cohorts, batches, states = [], [], []
    sample = engine.sampler.sample

    def recording_sample(ctx, rd):
        ids = sample(ctx, rd)
        cohorts.append([int(k) for k in ids])
        return ids

    engine.sampler.sample = recording_sample
    aggregate = engine.strategy.aggregate

    def recording_aggregate(ctx, state, results):
        new = aggregate(ctx, state, results)
        states.append(to_host(new))
        return new

    engine.strategy.aggregate = recording_aggregate
    batch_fn = engine.default_batch_fn()

    def recording_batch_fn(k):
        out = batch_fn(k)
        batches.append((k, [{n: _to_np(v) for n, v in b.items()}
                            for b in out]))
        return out

    _, history = engine.run(initial_state=state0, batch_fn=recording_batch_fn,
                            eval_every=1)
    return cohorts, batches, states, history


def _compare_runs(jax_run, torch_run, n_test, msg):
    (jc, jb, js, jh), (tc, tb, ts, th) = jax_run, torch_run
    assert tc == jc and len(tc) == 2
    assert len(tb) == len(jb) == sum(len(ids) for ids in tc)
    for (k1, b1), (k2, b2) in zip(tb, jb):
        assert k1 == k2 and len(b1) == len(b2)
        for x, y in zip(b1, b2):
            assert x.keys() == y.keys()
            for name in x:
                assert np.array_equal(x[name], y[name])
    assert len(ts) == len(js) == 2
    for rd, (a, b) in enumerate(zip(ts, js)):
        assert_trees_close(a, b, f"{msg} round {rd + 1}")
    assert [r.round for r in th] == [r.round for r in jh] == [1, 2]
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert [r.down_bytes for r in th] == [r.down_bytes for r in jh]
    assert all(r.down_bytes > 0 for r in th)
    for r1, r2 in zip(th, jh):
        assert abs(r1.accuracy - r2.accuracy) <= 1.0 / n_test


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


def _initial_states(method, jctx, ctx):
    """The reference's initial state, the port's copy of it, and how each
    side's state goes to the host for comparison.  The reference's
    parameters come from its jitted init (its eager init compiles every
    random draw)."""
    jcfg, key = jctx.model_cfg, jctx.key
    init = jax.jit(jresnet.init, static_argnums=1)
    if method == "splitmix":
        base_r = min(min(jctx.ratios), 1.0)
        jstate = object.__new__(JSplitMix)       # the bases set below
        jstate.base_cfg = j_subnet(jcfg, base_r)
        jstate.k = int(round(1 / base_r))
        jstate.bases = [init(k, jstate.base_cfg)
                        for k in jax.random.split(key, jstate.k)]
        state = SplitMixState(ctx.model_cfg, base_r, 0, device="cpu")
        assert state.k == jstate.k
        state.bases = params_from_reference(_host(jstate.bases),
                                            device="cpu")
        return (jstate, lambda s: _host(s.bases), state,
                lambda s: params_to_reference(s.bases))
    jparams = _host(init(key, jcfg))
    if method == "depthfl":
        jparams = (jparams, _host(jax.jit(j_aux, static_argnums=0)(
            jcfg, jax.random.fold_in(key, 7))))
    return (jparams, _host, params_from_reference(jparams, device="cpu"),
            params_to_reference)


@pytest.mark.parametrize("method", ["heterofl", "splitmix", "depthfl"])
def test_two_rounds_match_reference_engine(datasets, method):
    jdata, tdata = datasets
    jctx = j_context(jdata, JSim(**SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    ctx = build_context(tdata, SimConfig(**SIM),
                        model_cfg=reduced(num_classes=10, image_size=16),
                        device="cpu")
    assert np.array_equal(ctx.ratios, jctx.ratios)
    assert np.array_equal(ctx.budgets, jctx.budgets)
    jstrat, tstrat = j_get_strategy(method), registry.get_strategy(method)
    j0, j_host, t0, t_host = _initial_states(method, jctx, ctx)
    runs = {"jax": _run_recorded(JEngine(jstrat, jctx), j0, j_host),
            "torch": _run_recorded(RoundEngine(tstrat, ctx), t0, t_host)}
    clients = [k for ids in runs["torch"][0] for k in ids]
    if method == "splitmix":   # the first cap bases price the downlink
        for k in set(clients):
            assert tree_bytes(tstrat.downlink_tree(ctx, t0, k)) == \
                j_tree_bytes(jstrat.downlink_tree(jctx, j0, k))
    if method == "depthfl":
        assert tstrat.depths == jstrat.depths
        assert {tstrat.client_depth(ctx, k) for k in clients} == {2, 3}
    else:
        assert len({float(ctx.ratios[k]) for k in clients}) >= 3
    _compare_runs(runs["jax"], runs["torch"], DATA["n_test"], method)


def test_depthfl_lm_two_rounds_match_reference_engine():
    """DepthFL's LM branch (the prefix ``[0, depth)`` as one FeDepth
    block, masked aggregation by trained coverage) on the reduced
    mamba2-370m cut to 4 layers, 6 clients at ``fair`` budgets, all of
    them in each round: the r = 1 client trains all 4 layers, the others
    one."""
    jcfg = dataclasses.replace(j_lm_reduced("mamba2-370m"), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config("mamba2-370m"),
                              num_layers=4)
    data = dict(n_per_client=12, n_test=16, seq_len=16, seed=0)
    sim = dict(SIM, batch_size=4, participation=1.0)
    jctx = j_lm_context(j_seq_data(6, vocab_size=jcfg.vocab_size, **data),
                        JSim(**sim), jcfg, kernel_force="ref")
    ctx = build_lm_context(build_seq_data(6, vocab_size=cfg.vocab_size,
                                          device="cpu", **data),
                           SimConfig(**sim), cfg, device="cpu")
    jstrat, tstrat = j_get_strategy("depthfl"), registry.get_strategy(
        "depthfl")
    init = j_build(jcfg).init(jax.random.PRNGKey(0))
    runs = {"jax": _run_recorded(JEngine(jstrat, jctx), init, _host),
            "torch": _run_recorded(
                RoundEngine(tstrat, ctx),
                params_from_reference(_host(init), device="cpu"),
                params_to_reference)}
    assert tstrat.depths == jstrat.depths
    assert {tstrat.client_depth(ctx, k)
            for k in runs["torch"][0][0]} == {1, 4}
    _compare_runs(runs["jax"], runs["torch"], 16 * 16, "depthfl lm")


# ------------------------------------------------------------ samplers
def _ctx(num_clients=20, participation=0.25, seed=0):
    return Context(sim=SimConfig(participation=participation, seed=seed),
                   num_clients=num_clients, sizes=np.ones(num_clients),
                   rng=np.random.default_rng(seed), seed=seed,
                   device=torch.device("cpu"))


def _jctx(num_clients=20, participation=0.25, seed=0):
    return JContext(sim=JSim(participation=participation, seed=seed),
                    num_clients=num_clients, sizes=np.ones(num_clients),
                    rng=np.random.default_rng(seed), key=None)


def test_availability_trace_restricts_cohort():
    """Port of ``tests/test_engine.py::test_availability_trace_restricts_cohort``."""
    ctx = _ctx()
    s = AvailabilityTraceSampler([[0, 1, 2], [10, 11]])
    assert set(s.sample(ctx, 0)).issubset({0, 1, 2})
    assert set(s.sample(ctx, 1)).issubset({10, 11})
    assert set(s.sample(ctx, 2)).issubset({0, 1, 2})   # trace cycles
    with pytest.raises(ValueError):
        AvailabilityTraceSampler([])


def test_availability_trace_empty_round_falls_back():
    """Port of ``tests/test_engine.py::test_availability_trace_empty_round_falls_back``."""
    assert len(AvailabilityTraceSampler([[]]).sample(_ctx(), 0)) == 5


def test_straggler_sampler_subset_of_base_never_empty():
    """Port of ``tests/test_engine.py::test_straggler_sampler_subset_of_base_never_empty``."""
    ctx = _ctx(participation=0.5)
    s = StragglerSampler(drop_prob=0.9, base=UniformSampler())
    for rnd in range(10):
        cohort = s.sample(ctx, rnd)
        assert 1 <= len(cohort) <= 10
    with pytest.raises(ValueError):
        StragglerSampler(drop_prob=1.0)


SAMPLERS = {
    "trace": lambda m: m.AvailabilityTraceSampler(
        [[0, 3, 5, 7, 9, 11, 13], [], [2, 4, 6, 8, 10, 12, 14, 16, 18]]),
    "straggler": lambda m: m.StragglerSampler(drop_prob=0.4),
    "straggler over trace": lambda m: m.StragglerSampler(
        drop_prob=0.7, base=m.AvailabilityTraceSampler([[1, 2, 3, 4], []])),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_samplers_draw_the_reference_cohorts(name, seed):
    """Six rounds from the same seed: the reference's cohorts, in
    order."""
    import repro_torch.fl.sampling as tsampling
    got = {}
    for side, module, ctx in (("jax", jsampling, _jctx(seed=seed)),
                              ("torch", tsampling, _ctx(seed=seed))):
        sampler = SAMPLERS[name](module)
        got[side] = [sampler.sample(ctx, rd).tolist() for rd in range(6)]
    assert got["torch"] == got["jax"]


def test_registry_lists_all_six_methods():
    assert registry.available() == sorted(
        ["depthfl", "fedavg", "fedepth", "heterofl", "m-fedepth",
         "splitmix"])
    for name in registry.available():
        assert registry.get_strategy(name) is not \
            registry.get_strategy(name)
