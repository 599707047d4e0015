"""``AsyncEngine`` of the PyTorch port (``repro_torch.fl.systime``).

* Its zero-latency sync mode equals the port's ``RoundEngine`` bitwise.
* Against the reference's ``AsyncEngine`` on the verify recipe's tiny
  image run (reduced PreResNet, 8 clients, 320 synthetic 16 x 16
  images), from the same initial parameters, in sync and async mode,
  with and without the reference tests' HEAVY fault plan: the event
  trace equal element for element, ``sim_seconds``, up and down bytes
  equal, accuracies within one test image and the final parameters
  within the engine-parity tolerance of tests/test_torch_engine.py
  (atol 1e-4, rtol 1e-3).
* The deadline, availability, knob validation, and an async run in
  which overlapping dispatches are parked across server merges: no
  merge writes a parked snapshot or a parked result.

Each method's reference strategy and compiled client steps (its
context's ``caches``) are built once and shared by its cases, each case
with a fresh context."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl import systime as J  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.faults import FaultPlan as JPlan  # noqa: E402
from repro.fl.faults import ResiliencePolicy as JPolicy  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl import systime as T  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.faults import FaultPlan, ResiliencePolicy  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.sampling import UniformSampler  # noqa: E402
from repro_torch.fl.scale.state_store import InMemoryStore  # noqa: E402
from repro_torch.testing.convert import params_to_reference  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=160,
            image_size=16, seed=0)
SIM = dict(rounds=4, participation=0.5, lr=0.05, local_steps=1,
           batch_size=32, scenario="fair", seed=0)
HEAVY = dict(seed=7, crash_rate=0.1, drop_rate=0.1, corrupt_rate=0.15,
             diverge_rate=0.1, slowdown_rate=0.1)


@pytest.fixture(scope="module")
def datasets():
    return j_federated(**DATA), build_federated(**DATA, device="cpu")


def _ctx(datasets, **sim):
    return build_context(datasets[1], SimConfig(**{**SIM, **sim}),
                         model_cfg=reduced(num_classes=10, image_size=16),
                         device="cpu")


def _rows(history):
    # wall seconds are never bitwise; everything else must be
    return [(r.round, r.accuracy, r.comm_bytes, r.sim_seconds,
             r.down_bytes) for r in history]


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------------------ sync equivalence
@pytest.mark.parametrize("method", ["fedavg", "fedepth"])
def test_zero_latency_sync_equals_round_engine_bitwise(datasets, method):
    s0, h0 = RoundEngine(get_strategy(method),
                         _ctx(datasets)).run(eval_every=2)
    eng = T.AsyncEngine(get_strategy(method), _ctx(datasets), mode="sync")
    s1, h1 = eng.run(eval_every=2)
    assert _equal(s0, s1)
    assert _rows(h0) == _rows(h1)
    assert all(r.sim_seconds == 0.0 for r in h1)
    assert [t[0] for t in eng.trace].count("aggregate") == SIM["rounds"]


# ------------------------------------------------- parity vs reference
_SHARED = {}


def _reference(datasets, method):
    """The reference's strategy and context for ``method``: a fresh
    context each call, sharing the method's compiled steps."""
    jctx = j_context(datasets[0], JSim(**SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    if method not in _SHARED:
        _SHARED[method] = (j_get_strategy(method), jctx.caches)
    jstrat, caches = _SHARED[method]
    jctx.caches = caches
    return jstrat, jctx


PARITY = [("fedavg", "sync", False), ("fedavg", "async", False),
          ("fedepth", "sync", False), ("fedepth", "async", False),
          ("fedepth", "sync", True), ("fedepth", "async", True),
          ("heterofl", "async", False)]


@pytest.mark.parametrize("method,mode,faults", PARITY)
def test_matches_reference_engine(datasets, method, mode, faults):
    jstrat, jctx = _reference(datasets, method)
    tstrat, ctx = get_strategy(method), _ctx(datasets)
    kw = dict(mode=mode)
    if mode == "async":
        kw.update(concurrency=4, buffer_size=2)
    tkw = dict(kw, system=T.SystemModel(T.profiles_for_ratios(ctx.ratios)))
    jkw = dict(kw, system=J.SystemModel(J.profiles_for_ratios(jctx.ratios)))
    if faults:
        policy = "resample" if mode == "sync" else "accept"
        tkw.update(faults=FaultPlan(**HEAVY),
                   resilience=ResiliencePolicy(degradation=policy))
        jkw.update(faults=JPlan(**HEAVY),
                   resilience=JPolicy(degradation=policy))
    if hasattr(tstrat, "setup"):
        tstrat.setup(ctx)
    init = tstrat.init_state(ctx)
    port = T.AsyncEngine(tstrat, ctx, **tkw)
    ref = J.AsyncEngine(jstrat, jctx, **jkw)
    s_port, h_port = port.run(initial_state=init, eval_every=2)
    s_ref, h_ref = ref.run(initial_state=jax.tree.map(
        jax.numpy.asarray, params_to_reference(init)), eval_every=2)
    assert port.trace == ref.trace
    kinds = {t[0] for t in port.trace}
    assert "finish" in kinds and "aggregate" in kinds
    if faults:
        assert kinds & {"quarantine", "fail"}
    if mode == "async" and not faults:     # stale results were merged
        assert any(t[0] == "finish" and t[4] > 0 for t in port.trace)
    assert [(r.round, r.comm_bytes, r.down_bytes, r.sim_seconds)
            for r in h_port] == [(r.round, r.comm_bytes, r.down_bytes,
                                  r.sim_seconds) for r in h_ref]
    assert h_port[-1].sim_seconds > 0
    for a, b in zip(h_port, h_ref):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / DATA["n_test"]
    assert_trees_close(params_to_reference(s_port),
                       jax.tree.map(np.asarray, s_ref),
                       f"{method} {mode} faults={faults}")


# ------------------------------------------------------------- deadline
def test_deadline_drops_slow_clients(datasets):
    """Under a deadline exactly the over-deadline clients miss, and the
    server waits the deadline out."""
    slow = T.DeviceProfile("crawler", flops=float("inf"),
                           mem_bw=float("inf"), link_up=1.0,
                           link_down=float("inf"), mem_bytes=float("inf"))
    profiles = [slow if k < 4 else T.ZERO_LATENCY for k in range(8)]
    eng = T.AsyncEngine(get_strategy("fedavg"),
                        _ctx(datasets, rounds=2, participation=1.0),
                        system=T.SystemModel(profiles), mode="sync",
                        deadline_s=1.0)
    _, hist = eng.run(eval_every=1)
    misses = [t for t in eng.trace if t[0] == "miss"]
    finishes = [t for t in eng.trace if t[0] == "finish"]
    assert misses and all(t[2] < 4 for t in misses)
    assert finishes and all(t[2] >= 4 for t in finishes)
    assert hist[-1].sim_seconds == pytest.approx(2.0)


def test_deadline_never_stalls_even_if_all_miss(datasets):
    eng = T.AsyncEngine(get_strategy("fedavg"), _ctx(datasets, rounds=2),
                        system=T.SystemModel(T.uniform_profiles(
                            8, T.DEVICE_TIERS["iot"])),
                        mode="sync", deadline_s=1e-9)
    state, hist = eng.run(eval_every=1)
    assert len(hist) == 2
    assert not any(t[0] == "finish" for t in eng.trace)
    assert [t[0] for t in eng.trace].count("aggregate") == 2
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state))


def test_sync_prices_actual_batch_count(datasets):
    """A custom loader's real batch count drives the sync latency."""
    def run_with(n_batches):
        ctx = _ctx(datasets, rounds=1, participation=1.0)
        eng = T.AsyncEngine(get_strategy("fedavg"), ctx,
                            system=T.SystemModel(T.uniform_profiles(
                                8, T.DEVICE_TIERS["iot"])), mode="sync")
        rng = np.random.default_rng(0)
        _, hist = eng.run(eval_every=1, batch_fn=lambda k: [
            ctx.data.client_batch(k, 32, rng) for _ in range(n_batches)])
        return hist[-1].sim_seconds
    assert run_with(4) > run_with(1)


# --------------------------------------------------------- availability
def test_async_dispatch_respects_availability(datasets):
    """With only client 0 ever available, async mode dispatches only
    client 0 yet completes every server update."""
    eng = T.AsyncEngine(get_strategy("fedavg"), _ctx(datasets, rounds=3),
                        system=T.SystemModel(T.uniform_profiles(
                            8, T.DEVICE_TIERS["workstation"])),
                        availability=T.WindowedAvailability(
                            [(0.0, 1e9, [0])]),
                        mode="async", concurrency=3, buffer_size=1)
    _, hist = eng.run(eval_every=3)
    assert hist[-1].round == 3
    assert {t[2] for t in eng.trace if t[0] == "dispatch"} == {0}
    assert not any(t[0] == "dispatch_forced" for t in eng.trace)


def test_availability_in_both_modes(datasets):
    av = T.DutyCycleAvailability(10.0, 0.5, seed=0)
    eng = T.AsyncEngine(get_strategy("fedavg"), _ctx(datasets, rounds=3),
                        system=T.SystemModel(T.uniform_profiles(
                            8, T.DEVICE_TIERS["workstation"])),
                        availability=av, mode="async", concurrency=2,
                        buffer_size=1)
    _, hist = eng.run(eval_every=3)
    assert hist[-1].round == 3
    eng = T.AsyncEngine(get_strategy("fedavg"), _ctx(datasets, rounds=2),
                        system=T.SystemModel(T.uniform_profiles(
                            8, T.DEVICE_TIERS["phone"])),
                        availability=av, mode="sync")
    _, hist = eng.run(eval_every=1)
    assert len(hist) == 2 and hist[-1].sim_seconds > 0


# ------------------------------------------------------ knob validation
def test_knob_validation(datasets):
    ctx = _ctx(datasets)
    strat = get_strategy("fedavg")
    with pytest.raises(ValueError, match="sync-mode knob"):
        T.AsyncEngine(strat, ctx, mode="async", deadline_s=5.0)
    with pytest.raises(ValueError, match="mode='async'"):
        T.AsyncEngine(strat, ctx, mode="sync", buffer_size=3)
    with pytest.raises(ValueError, match="mode must be"):
        T.AsyncEngine(strat, ctx, mode="semi")
    with pytest.raises(ValueError, match="sampler"):
        T.AsyncEngine(strat, ctx, mode="async", sampler=UniformSampler())
    with pytest.raises(ValueError, match="sampler"):
        T.AsyncEngine(strat, ctx, mode="sync", sampler=UniformSampler(),
                      availability=T.DutyCycleAvailability(10.0, 0.5))
    with pytest.raises(ValueError, match="profiles"):
        T.AsyncEngine(strat, ctx, system=T.zero_latency_system(3))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        T.AsyncEngine(strat, ctx, checkpoint_every=2)
    # the scale and telemetry knobs are ported (tests/test_torch_scale.py,
    # tests/test_torch_obs.py): a store and a capture are taken, an
    # unknown telemetry spec is refused
    with pytest.raises(ValueError, match="obs must be"):
        T.AsyncEngine(strat, ctx, obs="loud")
    eng = T.AsyncEngine(strat, ctx, state_store=InMemoryStore(), obs="on")
    assert eng.obs is not None and eng.state_store is not None
    eng = T.AsyncEngine(strat, ctx)
    assert eng.concurrency == 4 and eng.buffer_size == 2


# ------------------------------------------------- private snapshots
def test_parked_snapshots_survive_server_merges(datasets):
    """Dispatches overlap merges (concurrency 4, buffer 1: a result lands
    on a state several versions newer): each dispatch's snapshot, its
    trained model, and its parked wire update (encoded against the
    snapshot, fp16 uplink: the reference it decodes onto and its decoded
    tree) read at every merge exactly as they were when parked."""
    strat = get_strategy("fedepth")
    eng = T.AsyncEngine(strat, _ctx(datasets, rounds=6),
                        system=T.SystemModel(T.profiles_for_ratios(
                            _ctx(datasets).ratios)),
                        mode="async", concurrency=4, buffer_size=1,
                        codec="fp16")
    parked = []
    update = strat.client_update

    def recording_update(ctx, state, k, batches):
        res = update(ctx, state, k, batches)
        parked.append((state, [t.clone() for t in tree_leaves(state)],
                       res.payload,
                       [t.clone() for t in tree_leaves(res.payload)]))
        return res

    strat.client_update = recording_update
    encode = eng.channel.encode_result
    wires = []

    def recording_encode(strategy, ctx, state, k, result):
        out = encode(strategy, ctx, state, k, result)
        wire = out.payload
        wires.append((wire, [t.clone() for t in tree_leaves(wire.ref)],
                      [t.clone() for t in tree_leaves(wire.decoded)]))
        return out

    eng.channel.encode_result = recording_encode
    apply = eng._apply_async
    checks = []

    def checked_apply(state, buffered):
        for snap, snap0, local, local0 in parked:
            checks.append(all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(snap), snap0)))
            checks.append(all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(local), local0)))
        for wire, ref0, dec0 in wires:
            checks.append(all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(wire.ref), ref0)))
            checks.append(all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(wire.decoded), dec0)))
        return apply(state, buffered)

    eng._apply_async = checked_apply
    state, hist = eng.run(eval_every=3)
    assert hist[-1].round == 6 and checks and all(checks)
    assert max(t[4] for t in eng.trace if t[0] == "finish") >= 2
    assert len(wires) == len(parked) > 6
