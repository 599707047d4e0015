"""System time of the PyTorch port (``repro_torch.fl.systime``) against
the reference (``repro.fl.systime``): the event loop, availability over
a grid of simulated times, the staleness discount, every device tier's
latency for every client of a reduced PreResNet and a reduced mamba2
context (exact float equality: the pricing is the same float
arithmetic), the strategies' ``client_work`` and their
``aggregate_async`` merges.

The reference merges the port's client results, converted, once per
module in the ``merges`` fixture."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_lm_reduced  # noqa: E402
from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl import systime as J  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.seq import build_lm_context as j_lm_context  # noqa: E402
from repro.fl.seq import build_seq_data as j_seq_data  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.fl import systime as T  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import SimConfig, build_context  # noqa: E402
from repro_torch.fl.registry import available, get_strategy  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.fl.strategy import ClientResult  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=160,
            image_size=16, seed=0)
SIM = dict(rounds=4, participation=0.5, lr=0.05, local_steps=1,
           batch_size=32, seed=0)
LM_DATA = dict(n_per_client=16, n_test=16, vocab_size=32, seq_len=12,
               seed=0)
LM_SIM = dict(rounds=2, participation=0.5, lr=0.1, local_steps=2,
              batch_size=8, scenario="fair", seed=0)


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


def _contexts(datasets, scenario="fair"):
    jdata, tdata = datasets
    jctx = j_context(jdata, JSim(scenario=scenario, **SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    ctx = build_context(tdata, SimConfig(scenario=scenario, **SIM),
                        model_cfg=reduced(num_classes=10, image_size=16),
                        device="cpu")
    return jctx, ctx


def _lm_contexts():
    jcfg = dataclasses.replace(j_lm_reduced("mamba2-370m"), num_layers=4)
    cfg = dataclasses.replace(get_reduced_config("mamba2-370m"),
                              num_layers=4)
    jctx = j_lm_context(j_seq_data(6, **LM_DATA), JSim(**LM_SIM), jcfg,
                        kernel_force="ref")
    ctx = build_lm_context(build_seq_data(6, device="cpu", **LM_DATA),
                           SimConfig(**LM_SIM), cfg, device="cpu")
    return jctx, ctx


# ------------------------------------------------------------------ clock
def test_event_loop_orders_as_the_reference():
    """Time order, FIFO on ties, ``now`` at the popped event: the same
    pops as the reference's loop for the same schedule; the same
    refusals."""
    delays = [2.0, 1.0, 1.0, 0.5, 3.0, 1.0, 0.0]
    loops = []
    for mod in (J, T):
        loop = mod.EventLoop()
        for i, d in enumerate(delays):
            loop.schedule(d, f"k{i}", client=i)
        loop.advance(0.0)
        pops = []
        while len(loop):
            ev = loop.pop()
            pops.append((ev.time, ev.seq, ev.kind, ev.client, loop.now))
        loops.append(pops)
        with pytest.raises(IndexError):
            loop.pop()
        with pytest.raises(ValueError):
            loop.schedule(-1.0, "x")
        with pytest.raises(ValueError):
            loop.advance(-1.0)
    assert loops[0] == loops[1]
    assert [p[2] for p in loops[1][:4]] == ["k6", "k3", "k1", "k2"]


# ---------------------------------------------------------- availability
def test_availability_matches_reference_over_a_grid():
    class Ctx:
        num_clients = 20

    grid = np.linspace(0.0, 250.0, 101)
    windows = [(0.0, 10.0, [0, 1]), (10.0, 20.0, [2, 3]),
               (15.0, 30.0, [3, 9, 4])]
    pairs = [(J.AlwaysAvailable(), T.AlwaysAvailable()),
             (J.WindowedAvailability(windows),
              T.WindowedAvailability(windows)),
             (J.WindowedAvailability(windows, period=50.0),
              T.WindowedAvailability(windows, period=50.0)),
             (J.DutyCycleAvailability(100.0, 0.5, seed=7),
              T.DutyCycleAvailability(100.0, 0.5, seed=7)),
             (J.DutyCycleAvailability(10.0, 0.05, seed=1),
              T.DutyCycleAvailability(10.0, 0.05, seed=1))]
    for ref, port in pairs:
        for t in grid:
            assert np.array_equal(ref.available(Ctx, float(t)),
                                  port.available(Ctx, float(t))), (port, t)
    with pytest.raises(ValueError):
        T.DutyCycleAvailability(10.0, 0.0)
    with pytest.raises(ValueError):
        T.WindowedAvailability([])


# ------------------------------------------------------------- staleness
def test_polynomial_discount_matches_reference():
    for tau in range(0, 40):
        for alpha in (0.0, 0.25, 0.5, 1.0, 2.0):
            assert T.polynomial_discount(tau, alpha) \
                == J.polynomial_discount(tau, alpha)
    d = [T.polynomial_discount(t, alpha=0.5) for t in range(5)]
    assert d == sorted(d, reverse=True) and d[0] == 1.0
    with pytest.raises(ValueError):
        T.polynomial_discount(-1)
    with pytest.raises(ValueError):
        T.polynomial_discount(1, alpha=-0.5)
    res = [ClientResult(None, 4.0), ClientResult(None, 2.0)]
    out = T.discount_results(res, [0, 3], alpha=0.5)
    assert [r.weight for r in out] == [4.0, 2.0 * 4.0 ** -0.5]
    assert [r.weight for r in res] == [4.0, 2.0]      # copies


# -------------------------------------------------------------- profiles
def test_profiles_match_reference():
    ratios = np.array([1 / 6, 1 / 3, 1 / 2, 1.0, 2.0, 1 / 6, 1.0])
    assert [p.name for p in T.profiles_for_ratios(ratios)] \
        == [p.name for p in J.profiles_for_ratios(ratios)]
    assert [p.name for p in T.profiles_for_ratios(ratios[:2])] \
        == ["iot", "workstation"]
    mix = {"iot": 0.3, "phone": 0.25, "workstation": 0.45}
    assert [p.name for p in T.mixed_profiles(10, mix, seed=3)] \
        == [p.name for p in J.mixed_profiles(10, mix, seed=3)]
    for name, prof in T.DEVICE_TIERS.items():
        assert dataclasses.astuple(prof) \
            == dataclasses.astuple(J.DEVICE_TIERS[name])
    assert dataclasses.astuple(T.ZERO_LATENCY) \
        == dataclasses.astuple(J.ZERO_LATENCY)


def _latencies(mod, ctx, contracts):
    """Every tier x every client x the byte / batch / contract grid."""
    out = []
    tiers = list(mod.DEVICE_TIERS.values()) + [mod.ZERO_LATENCY]
    for prof in tiers:
        system = mod.SystemModel(mod.uniform_profiles(ctx.num_clients,
                                                      prof),
                                 overhead_s=0.25)
        for prefix_cache, stable in contracts:
            c = dataclasses.replace(ctx, prefix_cache=prefix_cache)
            for k in range(ctx.num_clients):
                for up, down, nb in ((10 ** 6, 3 * 10 ** 6, 2),
                                     (12345, 0, 5)):
                    lat = system.latency(c, k, upload_bytes=up,
                                         download_bytes=down, n_batches=nb,
                                         prefix_stable=stable)
                    width = system.latency(
                        c, k, upload_bytes=up, download_bytes=down,
                        n_batches=nb, work=float(min(ctx.ratios[k], 1.0)))
                    out.append((prof.name, prefix_cache, stable, k, up, nb,
                                lat.download, lat.compute, lat.upload,
                                lat.total, width.compute))
    return out


@pytest.mark.parametrize("kind", ["resnet", "mamba2"])
def test_latency_equals_reference_exactly(datasets, kind):
    """The same seconds to the last bit, for every tier and client, both
    prefix-cache contracts and both buffered-prefix schedules, a
    decomposition's and a width ratio's work."""
    jctx, ctx = _contexts(datasets) if kind == "resnet" else _lm_contexts()
    assert [d.blocks for d in ctx.decomps] == \
        [d.blocks for d in jctx.decomps]
    assert any(len(d.blocks) >= 2 for d in ctx.decomps)
    contracts = [(True, True), (True, False), (False, None), (True, None)]
    ref, port = _latencies(J, jctx, contracts), \
        _latencies(T, ctx, contracts)
    assert port == ref
    assert any(row[7] > 0 for row in port)


@pytest.mark.parametrize("method", available())
def test_client_work_matches_reference(datasets, method):
    jctx, ctx = _contexts(datasets)
    jstrat, tstrat = j_get_strategy(method), get_strategy(method)
    for strat, c in ((jstrat, jctx), (tstrat, ctx)):
        if getattr(strat, "setup", None) is not None:
            strat.setup(c)
    jwork = getattr(jstrat, "client_work", None)
    twork = getattr(tstrat, "client_work", None)
    assert (jwork is None) == (twork is None)
    if twork is None:                  # FeDepth prices its decomposition
        return
    for k in range(ctx.num_clients):
        a, b = twork(ctx, k), jwork(jctx, k)
        if isinstance(b, float):
            assert a == b
        else:
            assert (a.blocks, a.skipped_prefix) == \
                (b.blocks, b.skipped_prefix)


def test_depthfl_client_work_on_an_lm_matches_reference():
    jctx, ctx = _lm_contexts()
    jstrat, tstrat = j_get_strategy("depthfl"), get_strategy("depthfl")
    jstrat.setup(jctx)
    tstrat.setup(ctx)
    for k in range(ctx.num_clients):
        assert tstrat.client_work(ctx, k).blocks \
            == jstrat.client_work(jctx, k).blocks


# ---------------------------------------------------------- async merges
MERGES = ("fedavg", "fedepth", "heterofl")
STALE = [0, 2, 5]


@pytest.fixture(scope="module")
def merges(datasets):
    """For each merge method: the port's context and strategy, its initial
    state and three client results (ids 0-2, scenario ``lack`` so that
    some client skips a prefix), all as reference-layout numpy, and the
    reference's ``aggregate_async`` of those results at stalenesses
    ``STALE``.  The results are the port's own updates: a merge is held
    to the reference's on the same inputs, whatever trained them."""
    from repro.fl.strategy import ClientResult as JResult
    out = {}
    for method in MERGES:
        jctx, ctx = _contexts(datasets, "lack")
        jstrat, tstrat = j_get_strategy(method), get_strategy(method)
        for strat, c in ((jstrat, jctx), (tstrat, ctx)):
            if getattr(strat, "setup", None) is not None:
                strat.setup(c)
        state = tstrat.init_state(ctx)
        payloads = []
        for k in range(3):
            batch = ctx.data.client_batch(k, 32, ctx.rng)
            r = tstrat.client_update(ctx, state, k, [batch])
            payloads.append((params_to_reference(r.payload), r.weight))
        host = params_to_reference(state)
        want = jstrat.aggregate_async(
            jctx, jax.tree.map(jax.numpy.asarray, host),
            [JResult(jax.tree.map(jax.numpy.asarray, p), w, client_id=k)
             for k, (p, w) in enumerate(payloads)], STALE, alpha=0.5)
        out[method] = (ctx, tstrat, host, payloads,
                       jax.tree.map(np.asarray, want))
    return out


def _port_results(payloads):
    return [ClientResult(params_from_reference(p, device="cpu"), w,
                         client_id=k)
            for k, (p, w) in enumerate(payloads)]


def _to_ref(tree):
    return params_to_reference(tree)


@pytest.mark.parametrize("method", MERGES)
def test_aggregate_async_matches_reference(merges, method):
    """Stalenesses 0, 2 and 5 at alpha 0.5: the port's merge equals the
    reference's on the same results within 1e-6."""
    ctx, strat, state, payloads, want = merges[method]
    got = strat.aggregate_async(ctx, params_from_reference(state,
                                                           device="cpu"),
                                _port_results(payloads), STALE, alpha=0.5)
    assert_trees_close(_to_ref(got), want, f"{method} aggregate_async",
                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("method", MERGES)
def test_aggregate_async_at_zero_staleness_is_aggregate(merges, method):
    ctx, strat, state, payloads, _ = merges[method]
    s = params_from_reference(state, device="cpu")
    results = _port_results(payloads)
    sync = strat.aggregate(ctx, s, results)
    merged = strat.aggregate_async(ctx, s, results, [0, 0, 0], alpha=0.5)
    for a, b in zip(tree_leaves(sync), tree_leaves(merged)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def _moved(a, b) -> float:
    return sum(float((x - y).abs().sum())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_fedavg_staleness_anchors_toward_server(merges):
    """A fully stale result moves the server less than a fresh one."""
    ctx, strat, state, payloads, _ = merges["fedavg"]
    s = params_from_reference(state, device="cpu")
    r = _port_results(payloads)[:1]
    fresh = strat.aggregate_async(ctx, s, r, [0], alpha=0.5)
    stale = strat.aggregate_async(ctx, s, r, [8], alpha=0.5)
    assert _moved(stale, s) < _moved(fresh, s)


def test_fedepth_per_block_staleness_protects_untrained_prefix(merges):
    """A stale partial-training client's untrained leaves (the carried
    stale copy) move the server less than its trained ones."""
    ctx, strat, state, _, _ = merges["fedepth"]
    skippers = [k for k, d in enumerate(ctx.decomps) if d.skipped_prefix]
    assert skippers, "lack should produce partial-training clients"
    k = skippers[0]
    s = params_from_reference(state, device="cpu")
    res = ClientResult(tree_map(lambda x: x + 1.0, s), 1.0, client_id=k)
    out = strat.aggregate_async(ctx, s, [res], [4], alpha=0.5)
    tm = aggregation.trained_mask_for(s, ctx.decomps[k], strat.runner)
    moved = [(float((o - x).abs().mean()), float(m.max()))
             for o, x, m in zip(tree_leaves(out), tree_leaves(s),
                                tree_leaves(tm))]
    frozen = [d for d, m in moved if m == 0.0]
    trained = [d for d, m in moved if m == 1.0]
    assert frozen and max(frozen) < max(trained)
    assert len(ctx.caches["fedepth_async_masks"]) >= 1
