"""The scale layer of the PyTorch port (``repro_torch.fl.scale``) against
the reference's (``repro.fl.scale``), twin of ``tests/test_scale.py``.

* Populations: every hashed draw, the synthesized batches and the
  ``PopulationSampler``'s cohorts equal the reference's exactly (client
  ids up to 10^6 - 1); the context is lazy (a 10^9-client population
  builds in milliseconds); a 2-round population FeDepth engine run
  matches the reference engine from the same initial parameters, bytes
  exact, states within the engine tolerances (atol 1e-4, rtol 1e-3).
* ``ShardedScheduler``: ``_chunk_widths`` equals the reference's over a
  grid; on the CPU its lanes over four (CPU) devices, over one and with
  ``max_lanes=2`` are BITWISE the vectorized scheduler's (measured: the
  narrower vmap widths change no lane bit here); a single-group,
  single-chunk fused round is bitwise ``aggregate_masked``; an
  ineligible ``run_fused`` returns ``NotImplemented`` without drawing;
  on an LM runner it raises the vectorized path's item-12 error.
* State stores: spill cycles of EF residuals (fp32 and bf16) and an
  ``AsyncEngine(state_store=SpillStore(2))`` run with a lossy channel on
  the same store, checkpointed, killed and resumed — all bitwise the
  in-memory run.
* History: the sink's lines equal the reference engine's in every field
  but wall seconds, for ``RoundEngine`` and ``AsyncEngine`` (whose trace
  lines too).

Sizes: reduced PreResNet at 16 x 16, 8 clients (populations: a cohort of
4); the reference's runs are made once per module.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.core import aggregation as j_aggregation  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.scale import executor as j_executor  # noqa: E402
from repro.fl.scale import history as j_history  # noqa: E402
from repro.fl.scale import population as j_population  # noqa: E402
from repro.fl.systime import AsyncEngine as JAsync  # noqa: E402
from repro.fl.systime import SystemModel as JSystem  # noqa: E402
from repro.fl.systime import mixed_profiles as j_mixed  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.fl.comm import CommChannel  # noqa: E402
from repro_torch.fl.comm.error_feedback import ErrorFeedback  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.sampling import (SequentialScheduler,  # noqa: E402
                                     VectorizedScheduler)
from repro_torch.fl.scale import (FOLD_LANES_EXACT,  # noqa: E402
                                  HashedDutyCycle, InMemoryStore,
                                  JsonlHistorySink, Population,
                                  PopulationSampler, PrefixedStore,
                                  ShardedScheduler, SpillStore,
                                  masked_partials, mesh_aggregate_masked,
                                  psum_masked_partials)
from repro_torch.fl.scale import population as population_mod  # noqa: E402
from repro_torch.fl.scale.history import read_jsonl, sanitize  # noqa: E402
from repro_torch.fl.scale.population import population_system  # noqa: E402
from repro_torch.fl.strategies.fedepth import FedepthStrategy  # noqa: E402
from repro_torch.fl.systime import (AsyncEngine, DutyCycleAvailability,  # noqa: E402
                                    SystemModel, mixed_profiles,
                                    profiles_for_ratios)
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_bytes, tree_leaves, tree_map  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=160,
            image_size=16, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, local_steps=1,
           batch_size=32, scenario="fair", seed=0)
MIX = {"iot": 0.25, "phone": 0.5, "workstation": 0.25}
CFG = reduced(num_classes=10, image_size=16)
# a 10^6-client population, a cohort of 4 a round
POP = dict(num_clients=1_000_000, scenario="fair", seed=1, image_size=16)
POP_SIM = dict(rounds=2, participation=4e-6, lr=0.05, local_steps=1,
               batch_size=32, seed=0)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _ctx(**sim):
    return build_context(TDATA, SimConfig(**{**SIM, **sim}), model_cfg=CFG,
                         device="cpu")


TDATA = build_federated(**DATA, device="cpu")


def _rows(lines):
    """History sink lines minus the wall seconds."""
    return [{k: v for k, v in r.items() if k != "seconds"} for r in lines]


# --------------------------------------------------------------------------
# the reference's runs, made once
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's population engine run and its history-sink runs
    (``RoundEngine`` and ``AsyncEngine``, FeDepth).  All three start from
    one initial state — the port's init in the reference's layout (the
    reference's own init compiles every draw) — and share one strategy
    and its compiled steps (the contexts' ``caches``)."""
    out = tmp_path_factory.mktemp("reference")
    jcfg = j_reduced(num_classes=10, image_size=16)
    init = params_to_reference(get_strategy("fedepth").init_state(_ctx()))
    strat = j_get_strategy("fedepth")
    pop = j_population.Population(**POP)
    jctx = j_context(None, JSim(**POP_SIM), population=pop, model_cfg=jcfg)
    strat.setup(jctx)
    pop_state, pop_hist = JEngine(
        strat, jctx, sampler=j_population.PopulationSampler(
            availability=pop)).run(initial_state=init, eval_every=1)
    jdata = j_federated(**DATA)
    for name, make in (
            ("round", lambda c, path: JEngine(strat, c, history_sink=path)),
            ("async", lambda c, path: JAsync(
                strat, c, system=JSystem(j_mixed(8, MIX, seed=0)),
                mode="async", history_sink=path))):
        c = j_context(jdata, JSim(**SIM), model_cfg=jcfg)
        c.caches = jctx.caches
        make(c, str(out / f"{name}.jsonl")).run(initial_state=init,
                                                eval_every=1)
    return dict(init=init, pop_state=jax.tree.map(np.asarray, pop_state),
                pop_hist=pop_hist,
                round_lines=read_jsonl(str(out / "round.jsonl")),
                async_lines=read_jsonl(str(out / "async.jsonl")))


# --------------------------------------------------------------------------
# populations
# --------------------------------------------------------------------------
IDS = np.asarray([0, 1, 17, 42, 123_456, 500_000, 999_998, 999_999])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("scenario", ["fair", "lack", "surplus"])
def test_population_draws_equal_reference(seed, scenario):
    """Ratios, sizes, label subsets, phases, availability and tiers at
    client ids up to 10^6 - 1, and the hash itself, bit for bit."""
    kw = dict(num_clients=1_000_000, scenario=scenario, seed=seed)
    a, b = Population(**kw), j_population.Population(**kw)
    np.testing.assert_array_equal(
        population_mod.hash_u64(seed, "ratio", IDS),
        j_population.hash_u64(seed, "ratio", IDS))
    np.testing.assert_array_equal(population_mod.uniform01(seed, "x", IDS),
                                  j_population.uniform01(seed, "x", IDS))
    np.testing.assert_array_equal(a.ratio(IDS), b.ratio(IDS))
    np.testing.assert_array_equal(a.size(IDS), b.size(IDS))
    np.testing.assert_array_equal(a.phase(IDS), b.phase(IDS))
    for t in (0.0, 1234.5):
        np.testing.assert_array_equal(a.up(IDS, t), b.up(IDS, t))
    for k in IDS:
        np.testing.assert_array_equal(a.labels(int(k)), b.labels(int(k)))
        assert a.profile(int(k)).name == b.profile(int(k)).name
    # positional, not sequential: any order, any batching
    np.testing.assert_array_equal(a.size(IDS[::-1])[::-1], a.size(IDS))
    hd, jhd = HashedDutyCycle(100.0, 0.3, seed=seed), \
        j_population.HashedDutyCycle(100.0, 0.3, seed=seed)
    np.testing.assert_array_equal(hd.up(np.arange(5000), 12.0),
                                  jhd.up(np.arange(5000), 12.0))
    system = population_system(a)
    assert len(system.profiles) == 1_000_000
    assert system.profiles[999_999] is a.profile(999_999)


def test_population_sampler_cohorts_and_batches_equal_reference():
    """The same draws from the shared stream in the same order: cohorts
    (with the availability rejection) and each client's synthesized
    batches, then the test split."""
    pop_kw = dict(POP, avail_duty=0.5)
    sim = SimConfig(**{**POP_SIM, "participation": 1e-5})
    ctx = build_context(None, sim, population=Population(**pop_kw),
                        model_cfg=CFG, device="cpu")
    jctx = j_context(None, JSim(**{**POP_SIM, "participation": 1e-5}),
                     population=j_population.Population(**pop_kw),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    s, js = PopulationSampler(availability=ctx.data.pop), \
        j_population.PopulationSampler(availability=jctx.data.pop)
    for rd in range(3):
        cohort, jcohort = s.sample(ctx, rd), js.sample(jctx, rd)
        assert cohort.tolist() == jcohort.tolist() and len(cohort) == 10
        assert ctx.data.pop.up(cohort, rd * 60.0).all()
        for k in cohort[:3]:
            b = ctx.data.client_batch(int(k), 64, ctx.rng)
            jb = jctx.data.client_batch(int(k), 64, jctx.rng)
            np.testing.assert_array_equal(b["images"].numpy(),
                                          jb["images"])
            np.testing.assert_array_equal(b["labels"].numpy(),
                                          jb["labels"])
    np.testing.assert_array_equal(ctx.data.x_test.numpy(),
                                  jctx.data.x_test)
    assert ctx.rng.bit_generator.state == jctx.rng.bit_generator.state
    for k in (3, 999_999):
        assert ctx.decomps[k].blocks == jctx.decomps[k].blocks
        assert ctx.budgets[k] == jctx.budgets[k]
        assert ctx.surplus[k] == jctx.surplus[k]


def test_population_context_is_lazy():
    """Nothing O(num_clients): a 10^9-client context builds at once, and
    decompositions are memoized per budget."""
    pop = Population(num_clients=10 ** 9, seed=1, image_size=16)
    ctx = build_context(None, SimConfig(participation=1e-9), population=pop,
                        model_cfg=CFG, device="cpu")
    assert ctx.num_clients == len(ctx.sizes) == len(ctx.decomps) == 10 ** 9
    decs = {id(ctx.decomps[int(k)]) for k in
            np.random.default_rng(0).integers(0, 10 ** 9, size=50)}
    assert len(decs) <= 4
    assert len(ctx.data.client_indices) == 10 ** 9


def test_population_engine_matches_reference(reference):
    """Two FeDepth rounds on a 10^6-client population (a cohort of 4),
    both engines from the reference's initial parameters: the same
    cohorts, up and down bytes exact, accuracies and states within the
    engine tolerances."""
    ctx = build_context(None, SimConfig(**POP_SIM),
                        population=Population(**POP), model_cfg=CFG,
                        device="cpu")
    eng = RoundEngine(get_strategy("fedepth"), ctx,
                      sampler=PopulationSampler(availability=ctx.data.pop))
    state, hist = eng.run(initial_state=params_from_reference(
        reference["init"], device="cpu"), eval_every=1)
    jh = reference["pop_hist"]
    assert [(r.round, r.comm_bytes, r.down_bytes) for r in hist] == \
        [(r.round, r.comm_bytes, r.down_bytes) for r in jh]
    for r, jr in zip(hist, jh):
        assert abs(r.accuracy - jr.accuracy) <= 1 / 512 + 1e-9
    assert_trees_close(params_to_reference(state), reference["pop_state"],
                       "population engine state")


# --------------------------------------------------------------------------
# the sharded scheduler
# --------------------------------------------------------------------------
def test_chunk_widths_equal_reference():
    for G in range(1, 41):
        for D in (1, 2, 3, 4, 8):
            for ml in (None, 2, 3, 8, 64):
                widths = ShardedScheduler._chunk_widths(G, D, ml)
                assert widths == j_executor.ShardedScheduler._chunk_widths(
                    G, D, ml), (G, D, ml)
                assert sum(widths) == G
                if G > 1:
                    assert all(w >= 2 for w in widths)


def _round(method, scheduler, scenario="fair", strategy=None):
    eng = RoundEngine(strategy or get_strategy(method),
                      _ctx(scenario=scenario, rounds=1), scheduler=scheduler)
    return eng.run(eval_every=1)


@pytest.mark.parametrize("method,scenario", [("fedavg", "fair"),
                                             ("fedepth", "lack")])
def test_sharded_lanes_bitwise_vectorized(method, scenario):
    """Over four devices (chunks of widths 2), one device (one chunk: the
    vectorized dispatch itself) and ``max_lanes=2``: the final state
    bitwise the vectorized scheduler's, the bytes equal."""
    sv, hv = _round(method, VectorizedScheduler(min_group=1), scenario)
    for sched in (ShardedScheduler(min_group=1, mesh=["cpu"] * 4),
                  ShardedScheduler(min_group=1, mesh=["cpu"]),
                  ShardedScheduler(min_group=1, mesh=["cpu"], max_lanes=2)):
        ss, hs = _round(method, sched, scenario)
        assert _equal(sv, ss)
        assert [r.comm_bytes for r in hv] == [r.comm_bytes for r in hs]


def test_fused_single_group_bitwise_aggregate_masked():
    """A cohort of one decomposition group, one chunk: the fused round
    (partials folded in the dispatch) equals the vectorized run +
    ``aggregate_masked`` bitwise; over four devices it holds at the
    vectorized tolerance (partial sums reassociate)."""
    ctx = _ctx(scenario="lack", rounds=1)
    key = ctx.decomps[0].blocks
    group = [k for k in range(8) if ctx.decomps[k].blocks == key]
    assert len(group) >= 2
    strat = FedepthStrategy(masked_aggregation=True)
    strat.setup(ctx)
    state = strat.init_state(ctx)
    start = ctx.rng.bit_generator.state
    batch_fn = RoundEngine(strat, ctx).default_batch_fn()
    results = VectorizedScheduler(min_group=1).run(ctx, strat, state, group,
                                                   batch_fn)
    want = strat.aggregate(ctx, state, results)
    for mesh, exact in ((["cpu"], True), (["cpu"] * 4, False)):
        ctx.rng.bit_generator.state = start
        got, comm = ShardedScheduler(min_group=1, aggregate="mesh",
                                     mesh=mesh).run_fused(
            ctx, strat, state, group, batch_fn)
        assert comm == len(group) * tree_bytes(state)
        if exact:
            assert _equal(want, got)
        else:
            for a, b in zip(tree_leaves(want), tree_leaves(got)):
                torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_partials_match_aggregate_masked(seed):
    """Random trees, 1-5 lanes, per-leaf {0, 1} masks (an all-zero leaf
    keeps the global value): the partials' combine equals
    ``aggregate_masked`` bitwise, and the reference's on the same numpy
    inputs within fp32 rounding; past ``FOLD_LANES_EXACT`` lanes the
    axis reduction holds to tolerance."""
    rng = np.random.default_rng(seed)
    G = int(rng.integers(1, 6))

    def tree():
        return {"a": torch.as_tensor(rng.normal(size=(3, 4)),
                                     dtype=torch.float32),
                "b": [torch.as_tensor(rng.normal(size=(5,)),
                                      dtype=torch.float32)]}
    glob, locals_ = tree(), [tree() for _ in range(G)]
    mask = tree_map(lambda x: torch.full_like(x, float(rng.integers(0, 2))),
                    glob)
    w = rng.integers(1, 200, size=G).astype(np.float32).tolist()
    stacked = tree_map(lambda *xs: torch.stack(xs), *locals_)
    part = psum_masked_partials([masked_partials(stacked, mask, w)],
                                torch.device("cpu"))
    got = mesh_aggregate_masked(glob, [part])
    assert _equal(got, aggregation.aggregate_masked(glob, locals_, w,
                                                    [mask] * G))
    to_np = lambda t: tree_map(lambda x: x.numpy(), t)  # noqa: E731
    want = j_aggregation.aggregate_masked(
        to_np(glob), [to_np(x) for x in locals_], w, [to_np(mask)] * G)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    # two chunks summed on one device, and the axis-reduction fold
    halves = [masked_partials(tree_map(lambda x: x[:1], stacked), mask,
                              w[:1])]
    if G > 1:
        halves.append(masked_partials(tree_map(lambda x: x[1:], stacked),
                                      mask, w[1:]))
    split = mesh_aggregate_masked(glob, [psum_masked_partials(
        halves, torch.device("cpu"))])
    many = FOLD_LANES_EXACT + 6
    big = tree_map(lambda x: x.expand(many, *x.shape[1:]).clone(),
                   tree_map(lambda x: x[:1], stacked))
    wide = mesh_aggregate_masked(glob, [masked_partials(big, mask,
                                                        [w[0]] * many)])
    narrow = aggregation.aggregate_masked(glob, [locals_[0]], w[:1], [mask])
    for a, b, c, d in zip(tree_leaves(got), tree_leaves(split),
                          tree_leaves(wide), tree_leaves(narrow)):
        torch.testing.assert_close(b, a, rtol=2e-6, atol=1e-6)
        torch.testing.assert_close(c, d, rtol=2e-6, atol=1e-6)


def test_run_fused_ineligible_draws_nothing():
    """An unmasked strategy: ``NotImplemented`` before any batch is drawn,
    the shared stream untouched; a plain strategy is delegated to the
    vectorized fallback in cohort order."""
    ctx = _ctx(rounds=1)
    strat = get_strategy("fedavg")
    strat.setup(ctx)
    state = strat.init_state(ctx)
    before = ctx.rng.bit_generator.state
    out = ShardedScheduler(aggregate="mesh", mesh=["cpu"]).run_fused(
        ctx, strat, state, [0, 1, 2],
        lambda k: pytest.fail("batch_fn must not run"))
    assert out is NotImplemented
    assert ctx.rng.bit_generator.state == before
    with pytest.raises(ValueError, match="aggregate"):
        ShardedScheduler(aggregate="psum")

    calls = []

    class Plain:
        def client_update(self, ctx, state, client_id, batches):
            calls.append(client_id)
            return client_id

    assert ShardedScheduler(mesh=["cpu"]).run(
        ctx, Plain(), None, [3, 1, 2], lambda k: []) == [3, 1, 2]
    assert calls == [3, 1, 2]


def test_sharded_on_lm_runner_raises_item_12():
    """The sharded scheduler on an LM runner once raised (the stacked LM
    path was missing); now it runs the strategy's group update per
    chunk.  On one device with ``max_lanes=None`` the one chunk is the
    vectorized dispatch: the round's state bitwise the vectorized
    scheduler's.  Over two devices the chunks run the same function over
    fewer lanes: within 1e-6.  Reduced qwen2-7b at 4 layers (K1 + K2), a
    cohort of 4 sharing one multi-block decomposition."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.fl.seq import build_lm_context, build_seq_data
    cfg = dataclasses.replace(get_reduced_config("qwen2-7b"), num_layers=4)

    def run(scheduler):
        data = build_seq_data(4, n_per_client=4, n_test=4,
                              vocab_size=cfg.vocab_size, seq_len=8, seed=0,
                              device="cpu")
        ctx = build_lm_context(data, SimConfig(
            rounds=1, participation=1.0, batch_size=2, scenario="fair",
            seed=0), cfg, device="cpu")
        # one group of 4: every client takes the deepest decomposition
        ctx.decomps = [max(ctx.decomps, key=lambda d: len(d.blocks))] * 4
        assert len(ctx.decomps[0].blocks) >= 2
        state, history = RoundEngine(get_strategy("fedepth"), ctx,
                                     scheduler=scheduler).run()
        return state, history

    vec, h_vec = run(VectorizedScheduler(min_group=2))
    one, h_one = run(ShardedScheduler(min_group=2, mesh=["cpu"]))
    two, h_two = run(ShardedScheduler(min_group=2, mesh=["cpu"] * 2))
    assert [r.comm_bytes for r in h_one] == [r.comm_bytes for r in h_vec] \
        == [r.comm_bytes for r in h_two]
    for a, b, c in zip(tree_leaves(vec), tree_leaves(one), tree_leaves(two)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=0, atol=1e-6)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(vec), tree_leaves(run(SequentialScheduler())[0])))
    assert moved <= 1e-4


# --------------------------------------------------------------------------
# state stores
# --------------------------------------------------------------------------
def test_spill_store_round_trip_bound_and_namespaces(tmp_path):
    with SpillStore(capacity=4, dir=str(tmp_path / "spill")) as store:
        values = {}
        rng = np.random.default_rng(0)
        for k in range(20):
            values[k] = (("tag", k % 3),
                         {"w": rng.normal(size=(3, 2)).astype(np.float32),
                          "t": torch.as_tensor(rng.normal(size=(2,)),
                                               dtype=torch.bfloat16),
                          "lst": [1, 2.5, None, "s"]})
            store[k] = values[k]
            assert store.resident() <= 4
        assert len(store) == 20 and store.spill_count >= 16
        for k in range(20):
            got = store.get(k)
            assert got[0] == values[k][0]
            np.testing.assert_array_equal(got[1]["w"], values[k][1]["w"])
            assert got[1]["t"].dtype == torch.bfloat16
            assert torch.equal(got[1]["t"], values[k][1]["t"])
            assert got[1]["lst"] == values[k][1]["lst"]
        store.pop(0)
        assert 0 not in store and len(store) == 19
    base = InMemoryStore()
    a, b = PrefixedStore(base, "ef"), PrefixedStore(base, "downlink")
    a[1], b[1] = "ra", "rb"
    assert a.get(1) == "ra" and b.get(1) == "rb" and len(base) == 2
    a.clear()
    assert a.get(1) is None and b.get(1) == "rb"


def test_error_feedback_residual_spill_cycle_bitwise(tmp_path):
    """A residual that left the hot set comes back bitwise, on its device
    and in its dtype, with its tag; a changed tag still resets."""
    gen = torch.Generator().manual_seed(0)
    t0 = {"w": torch.randn(4, 3, generator=gen),
          "h": torch.randn(5, generator=gen).to(torch.bfloat16)}
    with SpillStore(capacity=1, dir=str(tmp_path / "ef")) as store:
        ef, mem = ErrorFeedback(store=store), ErrorFeedback()
        for e in (ef, mem):
            e.update(0, t0, tree_map(lambda x: 0.5 * x, t0), tag="a")
            e.update(1, t0, tree_map(lambda x: 0.25 * x, t0), tag="b")
        assert store.resident() == 1 and store.spill_count == 1
        assert _equal(ef.correct(0, t0, tag="a"), mem.correct(0, t0,
                                                              tag="a"))
        assert store.load_count == 1
        res = ef.residual(0)
        assert res["h"].dtype == torch.float32 and res["w"].device.type \
            == "cpu"
        assert ef.correct(1, t0, tag="CHANGED")["w"] is t0["w"]
        assert ef.residual(1) is None
    with SpillStore(capacity=8, dir=str(tmp_path / "chan")) as store:
        chan = CommChannel("topk", downlink="delta", state_store=store)
        assert chan.ef._residuals.store is store
        assert chan._last_sent.store is store
        chan.ef.update(3, t0, t0)
        assert len(store) == 1
        chan.ef.reset()
        assert len(store) == 0


def test_duty_cycle_parks_its_phases(tmp_path):
    store = InMemoryStore()
    av, plain = DutyCycleAvailability(100.0, 0.5, seed=3, store=store), \
        DutyCycleAvailability(100.0, 0.5, seed=3)
    ctx = _ctx()
    np.testing.assert_array_equal(av.available(ctx, 7.0),
                                  plain.available(ctx, 7.0))
    assert list(store) == [("phases", 8)]


def _async_engine(store=None, **kw):
    ctx = _ctx(rounds=4)
    chan = CommChannel("qsgd_int8", "delta", state_store=store)
    return AsyncEngine(get_strategy("fedepth"), ctx, mode="async",
                       concurrency=4, buffer_size=2,
                       system=SystemModel(profiles_for_ratios(ctx.ratios)),
                       channel=chan, state_store=store, **kw)


def test_async_spill_store_and_resume_bitwise(tmp_path):
    """``AsyncEngine`` and its lossy channel over one ``SpillStore(2)``:
    bitwise the in-memory run (state, history rows, trace); then the same
    checkpointed every 2 versions, the newest pair deleted and resumed:
    bitwise again, the parked snapshots materialized in the checkpoint
    and re-parked."""
    def rows(h):
        return [(r.round, r.accuracy, r.comm_bytes, r.sim_seconds,
                 r.down_bytes) for r in h]

    e0 = _async_engine()
    s0, h0 = e0.run(eval_every=1)
    store = SpillStore(2, dir=str(tmp_path / "spill"))
    e1 = _async_engine(store)
    s1, h1 = e1.run(eval_every=1)
    assert _equal(s0, s1) and rows(h0) == rows(h1) and e0.trace == e1.trace
    assert store.spill_count > 0 and store.load_count > 0
    assert all(k[0] in ("inflight", "ef", "downlink") for k in store.keys())

    d = str(tmp_path / "ckpt")
    kw = dict(checkpoint_every=2, checkpoint_dir=d)
    e2 = _async_engine(SpillStore(2, dir=str(tmp_path / "s2")), **kw)
    s2, h2 = e2.run(eval_every=1)
    pairs = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    os.remove(os.path.join(d, pairs[-1]))
    os.remove(os.path.join(d, pairs[-1][:-4] + ".aux"))
    e3 = _async_engine(SpillStore(2, dir=str(tmp_path / "s3")), resume=True,
                       **kw)
    s3, h3 = e3.run(eval_every=1)
    assert _equal(s0, s3) and _equal(s2, s3)
    assert rows(h2) == rows(h3) and e2.trace == e3.trace
    assert [e for e in e3.trace if e[0] != "checkpoint"] == e0.trace


# --------------------------------------------------------------------------
# history sinks
# --------------------------------------------------------------------------
def test_round_engine_sink_lines_equal_reference(reference, tmp_path):
    path = str(tmp_path / "round.jsonl")
    with JsonlHistorySink(path) as sink:
        eng = RoundEngine(get_strategy("fedepth"), _ctx(),
                          history_sink=sink)
        _, hist = eng.run(initial_state=params_from_reference(
            reference["init"], device="cpu"), eval_every=1)
        assert hist == [] and sink.records == 2
    lines, jlines = read_jsonl(path), reference["round_lines"]
    assert [r["kind"] for r in lines] == ["round", "round"]
    rows, jrows = _rows(lines), _rows(jlines)
    for r, jr in zip(rows, jrows):
        assert abs(r.pop("accuracy") - jr.pop("accuracy")) <= 1 / 160 + 1e-9
    assert rows == jrows


def test_async_engine_sink_lines_equal_reference(reference, tmp_path):
    """Round lines and trace lines, in stream order, equal the
    reference's in every field but wall seconds (accuracy within one
    test image); ``run`` returns no history and keeps no trace."""
    path = str(tmp_path / "async.jsonl")
    eng = AsyncEngine(get_strategy("fedepth"), _ctx(),
                      system=SystemModel(mixed_profiles(8, MIX, seed=0)),
                      mode="async", history_sink=path)
    assert eng._owns_sink
    _, hist = eng.run(initial_state=params_from_reference(
        reference["init"], device="cpu"), eval_every=1)
    assert hist == [] and eng.trace == [] and eng.history_sink._f is None
    lines, jlines = read_jsonl(path), reference["async_lines"]
    assert [r["kind"] for r in lines] == [r["kind"] for r in jlines]
    assert [r for r in lines if r["kind"] == "trace"] == \
        [r for r in jlines if r["kind"] == "trace"]
    rows = _rows([r for r in lines if r["kind"] == "round"])
    jrows = _rows([r for r in jlines if r["kind"] == "round"])
    for r, jr in zip(rows, jrows):
        assert abs(r.pop("accuracy") - jr.pop("accuracy")) <= 1 / 160 + 1e-9
    assert rows == jrows and rows


def test_sink_copy_equals_reference(tmp_path):
    """``sanitize`` and the sink's lines equal the reference's copy on
    the same records, non-finite values mapped to null; a truncated last
    line is skipped on read."""
    rec = {"round": 1, "accuracy": float("nan"), "seconds": float("inf"),
           "nested": [np.float32("-inf"), np.int64(3), 1.5, np.bool_(True)]}
    assert sanitize(rec) == j_history.sanitize(rec)
    for mod, name in ((None, "port"), (j_history, "ref")):
        cls = JsonlHistorySink if mod is None else mod.JsonlHistorySink
        with cls(str(tmp_path / f"{name}.jsonl"), fsync_every=1) as sink:
            sink.write(rec)
            sink.write_trace(("finish", float("nan"), 2, 0, 0.5))
            sink.emit("metric", name="x", value=np.float64(2.0))
    port = (tmp_path / "port.jsonl").read_text()
    assert port == (tmp_path / "ref.jsonl").read_text()
    json.loads(port.splitlines()[0], parse_constant=lambda s: pytest.fail(
        f"bare {s} token"))
    with open(tmp_path / "port.jsonl", "a") as f:
        f.write('{"kind": "round", "rou')
    with pytest.warns(UserWarning, match="truncated"):
        assert len(read_jsonl(str(tmp_path / "port.jsonl"))) == 3
    assert len(read_jsonl(str(tmp_path / "ref.jsonl"), kind="trace")) == 1
